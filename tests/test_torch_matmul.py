"""The port's `matmul` / `matmul_int8w` / `matmul_int4w`
(simpleinfer_tpu_torch.kernels.matmul) against the JAX package's Pallas
kernels and their jnp oracles.

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
  two sides may round an f32 value on either side of a bf16 boundary;
- the tensor-core routes' order of sums (bf16 operands, f32 sums of k16
  chunks, int8 w and int4 nibbles exact in bf16) against the plain
  versions: chip_smoke's kernel-vs-plain limit, 1e-4 x max(1, |ref|)
  plus one bf16 ulp for a bf16 output.
"""
import importlib
import os
import sys

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from simpleinfer_tpu.quant.tensor import quantize_int4_grouped as jquant4
from simpleinfer_tpu.quant.tensor import quantize_per_channel as jquant
from simpleinfer_tpu_torch.kernels import matmul as tmm
from simpleinfer_tpu_torch.quant.tensor import quantize_int4_grouped as tquant4
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


# ---- int4w: quantize_int4_grouped and matmul_int4w ----------------------
# (M, K, N, group): the decode GEMV shape class, ragged K (not a multiple
# of the group: zero-padded rows), ragged N, a prefill-like M
INT4_SHAPES = [(16, 256, 96, 128), (5, 200, 70, 64), (37, 129, 131, 64),
               (64, 384, 128, 128), (1, 32, 8, 32)]


def _int4_case(m, k, n, seed=0):
    rng = np.random.default_rng(seed + 11 * m + k + n)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    b = 0.1 * rng.standard_normal(n).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("m,k,n,group", INT4_SHAPES)
def test_quantize_int4_grouped_equal(m, k, n, group):
    """Packed bytes, scales, group and logical K byte-equal to the JAX
    package's; the dequantized weights equal."""
    w = _int4_case(m, k, n)[1]
    w[:, 0] = 0.0          # an all-zero column takes scale 1.0 in both
    j, t = jquant4(w, group=group), tquant4(w, group=group)
    assert (t.group, t.k) == (j.group, j.k)
    assert t.packed.dtype == torch.int8 and t.shape == tuple(j.shape)
    assert t.packed.numpy().tobytes() == np.asarray(j.packed).tobytes()
    assert t.scale.numpy().tobytes() == np.asarray(j.scale).tobytes()
    np.testing.assert_array_equal(t.dequantize().numpy(),
                                  np.asarray(j.dequantize()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,group", INT4_SHAPES)
def test_int4w_vs_jnp_oracle(m, k, n, group, dtype):
    """matmul_int4w (its plain version on the CPU) against the JAX
    matmul_int4w_ref, bias + silu, f32 out and the input dtype out:
    1e-5 x scale (the same f32 dequant and sums in another order), plus
    one bf16 ulp for a bf16 output."""
    x, w, b = _int4_case(m, k, n, seed=1)
    jq, tq = jquant4(w, group=group), tquant4(w, group=group)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    for out in (torch.float32, td):
        got = tmm.matmul_int4w(torch.from_numpy(x).to(td), tq,
                               torch.from_numpy(b), "silu", out_dtype=out)
        assert got.dtype == out
        want = jmm.matmul_int4w_ref(
            jnp.asarray(x).astype(jd), jq, jnp.asarray(b), "silu",
            out_dtype=jnp.float32 if out == torch.float32 else jd)
        _assert_close(got.float().numpy(),
                      np.asarray(want.astype(jnp.float32)), 1e-5,
                      out == torch.bfloat16)


@pytest.mark.parametrize("m,k,n,group", INT4_SHAPES)
def test_int4w_vs_pallas_interpret(m, k, n, group):
    """Against the Pallas kernel in interpret mode at 2e-2 x scale: the
    Pallas body rounds x and w * s to bf16 before its dots (a TPU means;
    the port dequantizes in f32, as matmul_int4w_ref does)."""
    x, w, b = _int4_case(m, k, n, seed=2)
    jq, tq = jquant4(w, group=group), tquant4(w, group=group)
    got = tmm.matmul_int4w(torch.from_numpy(x), tq, torch.from_numpy(b),
                           "silu").numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmm.matmul_int4w(
            jnp.asarray(x), jq, jnp.asarray(b), "silu",
            out_dtype=jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=2e-2)


def test_int4w_wrapper_checks_without_card():
    """CPU tensors take the plain version and launch nothing; another
    device goes to the kernel path, which raises (no fallback)."""
    x, w, _ = _int4_case(4, 64, 8)
    q = tquant4(w, group=32)
    before = tmm.launches_int4w
    out = tmm.matmul_int4w(torch.from_numpy(x), q)
    assert out.shape == (4, 8) and tmm.launches_int4w == before
    with pytest.raises(ValueError, match="CUDA"):
        tmm.matmul_int4w(torch.from_numpy(x).to("meta"), q)


# ---- the tensor-core route's arithmetic, emulated -------------------------
def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _int4w_mma_order(x, q, bias, act, out_dtype):
    """The bf16 route of csrc/matmul_int4w.cu in its arithmetic order:
    each group's bf16 x int4 products (exact) summed in f32, times the
    group's f32 scale, folded into an f32 sum group after group; then
    bias, activation and the cast."""
    p = q.packed.to(torch.int32)
    kp2, n = p.shape
    kg, half = q.scale.shape[0], q.group // 2
    hi = (p >> 4).reshape(kg, half, n)
    lo = (((p & 0xF) ^ 8) - 8).reshape(kg, half, n)
    wq = torch.cat([hi, lo], dim=1).float()            # [kg, group, N]
    xf = torch.zeros(x.shape[0], kg * q.group)
    xf[:, :q.k] = x.float()
    acc = torch.zeros(x.shape[0], n)
    for g in range(kg):
        part = xf[:, g * q.group:(g + 1) * q.group] @ wq[g]
        acc = acc + part * q.scale[g]
    if bias is not None:
        acc = acc + bias.float()
    return tmm.resolve_activation(act)(acc).to(out_dtype)


# chip_smoke's ragged int4w cases and the llama widths (K 2048 and 5456,
# group 128; N cut to keep the CPU quick)
INT4_MMA_CASES = [(1, 200, 70, 128), (37, 129, 131, 64), (100, 256, 50, 128),
                  (17, 384, 96, 128), (16, 2048, 33, 128), (64, 130, 64, 32),
                  (16, 2048, 256, 128), (64, 5456, 128, 128),
                  (17, 5456, 96, 128)]


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,group", INT4_MMA_CASES)
def test_int4w_mma_order_within_card_tolerance(m, k, n, group, out):
    """The tensor-core route's order of sums against the plain version
    (matmul_int4w_ref: f32 dequant, one f32 product), bf16 x, bias +
    silu, within chip_smoke's kernel-vs-plain limit: 1e-4 x max(1,
    |ref|), plus one bf16 ulp for a bf16 output."""
    cs = _chip_smoke()
    x, w, b = _int4_case(m, k, n, seed=3)
    q = tquant4(w, group=group)
    xt = torch.from_numpy(x).bfloat16()
    bt = torch.from_numpy(b).bfloat16()
    od = getattr(torch, out)
    got = _int4w_mma_order(xt, q, bt, "silu", od)
    ref = tmm.matmul_int4w_ref(xt, q, bt, "silu", out_dtype=od)
    lim = cs.KERNEL_ATOL * max(1.0, float(ref.float().abs().max()))
    _, ok, share = cs._close_tol(got, ref, lim, cs.KERNEL_BF16_RTOL
                                 if od == torch.bfloat16 else 0.0)
    assert ok, share


@pytest.mark.parametrize("n,k,splits", [(2048, 2048, 8), (512, 2048, 8),
                                        (5456, 2048, 6), (2048, 5456, 8),
                                        (32000, 2048, 2), (33, 200, 2)])
def test_int4w_decode_splits(n, k, splits):
    """The decode route's K slices at the llama projections on 132 SMs:
    whole groups each, about 2 x 132 blocks of 128 columns where the
    groups and a cluster's 8 blocks allow, and the count the C entry
    accepts."""
    groups = -(-k // 128)
    got = tmm.int4w_decode_splits(n, groups, 132)
    assert got == splits
    per = -(-groups // got)
    assert -(-groups // per) == got and 1 <= got <= min(groups, 8)


# ---- the bf16 tensor-core route of csrc/matmul.cu, emulated ---------------
def _mma_order(x, w, scale, bias, act, out_dtype):
    """The bf16 route of csrc/matmul.cu in its arithmetic order: bf16 x
    times w as bf16 (an int8 weight is exact in bf16), each k16 chunk's
    products summed in f32 (one mma.sync) and added into an f32
    accumulator chunk after chunk; then * scale[n] (the int8 dequant,
    after the product), + bias, the activation and one cast."""
    xf, wf = x.float(), w.to(torch.bfloat16).float()
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], 16):
        acc = acc + xf[:, k0:k0 + 16] @ wf[k0:k0 + 16]
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    return tmm.resolve_activation(act)(acc).to(out_dtype)


# the main paths' widths with M cut to keep the CPU quick: ResNet-50's
# pointwise convs (K / N 64 .. 2048), YOLOv5s's (N 32, 64, its Detect
# head's 255), and chip_smoke's ragged shapes (RAGGED_SHAPES)
MMA_CASES = [(64, 64, 256), (64, 256, 64), (48, 1024, 256), (32, 2048, 512),
             (32, 512, 2048), (96, 128, 512), (100, 32, 32), (100, 64, 64),
             (64, 512, 256), (64, 128, 255), (100, 60, 50), (1, 256, 255),
             (37, 129, 131), (8, 16, 8)]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_kind", ["int8", "bfloat16"])
@pytest.mark.parametrize("m,k,n", MMA_CASES)
def test_mma_order_within_card_tolerance(m, k, n, w_kind, out, bias):
    """csrc/matmul.cu's tensor-core route (bf16 x, int8 or bf16 w) in its
    order of sums against the plain version (matmul_int8w_ref /
    matmul_ref: one f32 product), bias + silu or neither, within
    chip_smoke's kernel-vs-plain limit."""
    cs = _chip_smoke()
    x, w, b = _case(m, k, n, seed=5)
    xt = torch.from_numpy(x).bfloat16()
    bt = torch.from_numpy(b) if bias else None
    act = "silu" if bias else None
    od = getattr(torch, out)
    if w_kind == "int8":
        q = tquant(w, axis=1)
        got = _mma_order(xt, q.data, q.scale, bt, act, od)
        ref = tmm.matmul_int8w_ref(xt, q.data, q.scale, bt, act, od)
    else:
        wt = torch.from_numpy(w).bfloat16()
        got = _mma_order(xt, wt, None, bt, act, od)
        ref = tmm.matmul_ref(xt, wt, bt, act, od)
    lim = cs.KERNEL_ATOL * max(1.0, float(ref.float().abs().max()))
    _, ok, share = cs._close_tol(got, ref, lim, cs.KERNEL_BF16_RTOL
                                 if od == torch.bfloat16 else 0.0)
    assert ok, share


@pytest.mark.parametrize("n,width", [(8, 64), (32, 64), (64, 64), (65, 128),
                                     (255, 128), (2048, 128)])
def test_mma_block_n(n, width):
    """The tensor-core tile's width the wrapper passes: 64 up to N 64
    (YOLOv5s's narrow convs), else 128."""
    assert tmm.mma_block_n(n) == width
