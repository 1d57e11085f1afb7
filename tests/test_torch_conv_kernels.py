"""conv3x3_s1_same and stem_s2d in the port (simpleinfer_tpu_torch.kernels)
against the JAX package, on the CPU: the plain versions (which the
wrappers run for CPU tensors) against the Pallas kernels in interpret
mode and their lax oracles, the host-side packing byte for byte, and the
wrappers' checks.

Tolerances, with scale = max(1, max|ref|):
- conv3x3 in f32: 1e-4 x scale (f32 sums in another order); in bf16 one
  bf16 ulp (2^-7 x |ref|) on top (the result rounds once to bf16 on
  each side, from sums that differ in the last f32 bits);
- stem_s2d (bf16 out): one bf16 ulp plus 1e-4 x scale, against the
  Pallas kernel and against stem_s2d_reference on the same bf16 inputs;
- pack_stem_input / pack_stem_weights: bytes equal.
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleinfer_tpu.kernels import conv3x3 as jconv
from simpleinfer_tpu.kernels import stem as jstem
from simpleinfer_tpu_torch.kernels import conv3x3 as tconv
from simpleinfer_tpu_torch.kernels import stem as tstem

BF16_ULP = 2.0 ** -7


def within(got, want, bf16):
    scale = max(1.0, float(np.abs(want).max()))
    lim = 1e-4 * scale + (BF16_ULP * np.abs(want) if bf16 else 0.0)
    d = np.abs(got - want)
    assert (d <= lim).all(), float(d.max())


# ---- conv3x3_s1_same ----------------------------------------------------------
@pytest.mark.parametrize("n,h,w,c,oc,dtype,act", [
    (2, 8, 8, 16, 24, "float32", "silu"),     # tests/test_kernels.py:119
    (1, 5, 7, 8, 8, "float32", "silu"),
    (1, 5, 7, 8, 8, "float32", None),
    (2, 6, 9, 12, 20, "bfloat16", "relu"),
    (1, 1, 1, 3, 5, "float32", "leaky_relu@0.1"),
])
def test_conv3x3_ref_matches_jax(n, h, w, c, oc, dtype, act):
    """The plain version against the Pallas kernel (interpret mode) and
    conv3x3_reference, with and without bias."""
    rng = np.random.default_rng(n * h + w + c)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, oc)) * 0.1).astype(np.float32)
    b = rng.standard_normal(oc).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for bias in (b, None):
        jb = None if bias is None else jnp.asarray(bias)
        tb = None if bias is None else torch.from_numpy(bias)
        got = tconv.conv3x3_s1_same_ref(
            torch.from_numpy(x).to(td), torch.from_numpy(wt), tb,
            act).float().numpy()
        kern = np.asarray(jconv.conv3x3_s1_same(
            jnp.asarray(x).astype(jd), jnp.asarray(wt), jb, act,
            interpret=True).astype(jnp.float32))
        ref = np.asarray(jconv.conv3x3_reference(
            jnp.asarray(x).astype(jd), jnp.asarray(wt), jb, act).astype(
            jnp.float32))
        assert got.shape == kern.shape == (n, h, w, oc)
        within(got, kern, dtype == "bfloat16")
        within(got, ref, dtype == "bfloat16")


def test_conv3x3_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 6)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 6, 7)).astype(
        np.float32))
    before = tconv.launches
    got = tconv.conv3x3_s1_same(x, w, None, "silu")
    assert torch.equal(got, tconv.conv3x3_s1_same_ref(x, w, None, "silu"))
    assert tconv.launches == before
    with pytest.raises(ValueError, match="3,3"):
        tconv.conv3x3_s1_same(x, w[:2], None)
    with pytest.raises(ValueError, match="bias"):
        tconv.conv3x3_s1_same(x, w, torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA"):
        tconv.conv3x3_s1_same(x.to("meta"), w.to("meta"))


# ---- stem_s2d ------------------------------------------------------------------
def _stem_case(n, oc, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 640, 640, 3)).astype(np.float32)
    w = (rng.standard_normal((oc, 3, 6, 6)) / 10).astype(np.float32)
    bias = (rng.standard_normal(oc) * 0.05).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("oc", [32, 64])
def test_pack_stem_bytes_equal(oc):
    x, w, _ = _stem_case(2, oc)
    assert tstem.pack_stem_input(x).tobytes() == \
        jstem.pack_stem_input(x).tobytes()
    assert tstem.pack_stem_weights(w).tobytes() == \
        jstem.pack_stem_weights(w).tobytes()
    u8 = (x * 255).astype(np.uint8)
    assert tstem.pack_stem_input(u8).tobytes() == \
        jstem.pack_stem_input(u8).tobytes()


def test_pack_stem_rejects_other_shapes():
    with pytest.raises(ValueError, match="640"):
        tstem.pack_stem_input(np.zeros((1, 320, 320, 3), np.float32))
    with pytest.raises(ValueError, match="6,6"):
        tstem.pack_stem_weights(np.zeros((32, 3, 3, 3), np.float32))


@pytest.mark.parametrize("act", ["silu", None])
def test_stem_ref_matches_pallas_interpret(act):
    """The plain version on the packed inputs against the Pallas kernel
    in interpret mode (N = 1), and against stem_s2d_reference on the
    same bf16 image and weights."""
    x, w, bias = _stem_case(1, 32)
    xp, wp = tstem.pack_stem_input(x), tstem.pack_stem_weights(w)
    got = tstem.stem_s2d_ref(torch.from_numpy(xp), torch.from_numpy(wp),
                             torch.from_numpy(bias), act)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 320, 320, 32)
    got = got.float().numpy()
    kern = np.asarray(jstem.stem_s2d(
        jnp.asarray(xp, jnp.bfloat16), jnp.asarray(wp), jnp.asarray(bias),
        activation=act, interpret=True), np.float32)
    within(got, kern, True)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(jstem.stem_s2d_reference(xb, wb, bias, act),
                     np.float32)
    within(got, ref, True)


def test_stem_wrapper_on_cpu_is_the_plain_version():
    x, w, bias = _stem_case(1, 64, seed=5)
    args = (torch.from_numpy(tstem.pack_stem_input(x)),
            torch.from_numpy(tstem.pack_stem_weights(w)),
            torch.from_numpy(bias))
    before = tstem.launches
    assert torch.equal(tstem.stem_s2d(*args, "silu"),
                       tstem.stem_s2d_ref(*args, "silu"))
    assert tstem.launches == before
    with pytest.raises(ValueError, match="645"):
        tstem.stem_s2d(args[0][:, :600], *args[1:])
    with pytest.raises(ValueError, match="128"):
        tstem.stem_s2d(args[0], args[1][:108], args[2])
    with pytest.raises(ValueError, match="CUDA"):
        tstem.stem_s2d(*(a.to("meta") for a in args))
