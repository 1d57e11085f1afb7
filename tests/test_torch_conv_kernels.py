"""conv3x3_s1_same and stem_s2d in the port (simpleinfer_tpu_torch.kernels)
against the JAX package, on the CPU: the plain versions (which the
wrappers run for CPU tensors) against the Pallas kernels in interpret
mode and their lax oracles, the host-side packing byte for byte, and the
wrappers' checks.

Tolerances, with scale = max(1, max|ref|):
- conv3x3 in f32: 1e-4 x scale (f32 sums in another order); in bf16 one
  bf16 ulp (2^-7 x |ref|) on top (the result rounds once to bf16 on
  each side, from sums that differ in the last f32 bits);
- the bf16 tensor-core route's order of sums (tap-major K, f32 sums of
  k16 chunks) against the plain version: one bf16 ulp plus 1e-4 x scale,
  chip_smoke's kernel-vs-plain limit;
- stem_s2d (bf16 out): one bf16 ulp plus 1e-4 x scale, against the
  Pallas kernel and against stem_s2d_reference on the same bf16 inputs;
- pack_stem_input / pack_stem_weights: bytes equal.
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _conv3x3_mma_order(x, w_hwio, bias, act):
    """csrc/conv3x3.cu's bf16 route in its arithmetic order: K walked
    tap-major, (dy, dx) then 16-channel chunks of C, each chunk's products
    of the shifted bf16 pixels (zero off the image) and the tap's bf16
    weight rows summed in f32 and added into an f32 accumulator; then
    bias, the activation and one rounding to bf16."""
    n, h, w, c = x.shape
    oc = w_hwio.shape[3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w_hwio.to(x.dtype).float()
    acc = torch.zeros(n * h * w, oc)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        xs = xp[:, dy:dy + h, dx:dx + w, :].reshape(-1, c)
        for c0 in range(0, c, 16):
            acc = acc + xs[:, c0:c0 + 16] @ wf[dy, dx, c0:c0 + 16]
    acc = acc.reshape(n, h, w, oc)
    if bias is not None:
        acc = acc + bias.float()
    return tconv.resolve_activation(act)(acc).to(x.dtype)


# the ResNet-50 (relu) and YOLOv5s (silu) 3x3 widths at small H x W, and
# chip_smoke's CONV_RAGGED (C and OC off 8 and 64, H x W down to 1 x 1)
CONV_MMA_CASES = [(1, 8, 8, 64, 64, "relu"), (1, 6, 6, 128, 128, "relu"),
                  (1, 5, 5, 256, 256, "relu"), (1, 4, 4, 512, 512, "relu"),
                  (2, 10, 10, 32, 32, "silu"), (1, 8, 8, 64, 64, "silu"),
                  (1, 6, 6, 128, 128, "silu"), (1, 4, 4, 256, 256, "silu"),
                  (2, 1, 1, 3, 5, "silu"), (2, 5, 7, 13, 17, "silu"),
                  (1, 3, 33, 70, 131, "silu"), (3, 5, 7, 129, 66, "silu")]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("n,h,w,c,oc,act", CONV_MMA_CASES)
def test_conv3x3_mma_order_within_card_tolerance(n, h, w, c, oc, act, bias):
    """The tensor-core route's order of sums against conv3x3_s1_same_ref
    on the same bf16 inputs, within the kernel-vs-plain limit."""
    rng = np.random.default_rng(n * h + w + c + oc)
    x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(
        np.float32)).bfloat16()
    wt = torch.from_numpy((rng.standard_normal((3, 3, c, oc))
                           / np.sqrt(9 * c)).astype(np.float32))
    b = (torch.from_numpy(0.1 * rng.standard_normal(oc).astype(np.float32))
         if bias else None)
    got = _conv3x3_mma_order(x, wt, b, act)
    ref = tconv.conv3x3_s1_same_ref(x, wt, b, act)
    assert got.dtype == ref.dtype == torch.bfloat16
    within(got.float().numpy(), ref.float().numpy(), True)


def test_conv3x3_block_n():
    """The tile width conv3x3_s1_same passes: 64 up to OC 64, else 128
    (kernels/matmul.mma_block_n)."""
    assert [tconv.mma_block_n(oc) for oc in (5, 32, 64, 66, 512)] == \
        [64, 64, 64, 128, 128]


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
