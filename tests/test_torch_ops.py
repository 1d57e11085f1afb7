"""Each ported lowering (simpleinfer_tpu_torch.ops) against the JAX
package's lowering of the same pnnx Operator, on random NHWC inputs made
with numpy, at the per-op tolerances of tests/test_ops.py (conv 2e-4
atol / 1e-4 rtol, pool and shape ops exact or 1e-6, binary 1e-6)."""
import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleinfer_tpu.config import EngineConfig as JCfg
from simpleinfer_tpu.ir import graph as jgraph
from simpleinfer_tpu.ops import lower_operator as jlower
from simpleinfer_tpu.quant.tensor import QuantizedTensor as JQ
from simpleinfer_tpu.quant.tensor import quantize_per_channel as jquant
from simpleinfer_tpu_torch.config import EngineConfig as TCfg
from simpleinfer_tpu_torch.ir import graph as tgraph
from simpleinfer_tpu_torch.kernels import matmul as tmm
from simpleinfer_tpu_torch.ops import lower_operator as tlower
from simpleinfer_tpu_torch.quant.tensor import quantize_per_channel as tquant

RNG = np.random.default_rng(7)
CONV_TOL = dict(atol=2e-4, rtol=1e-4)


def make_ops(type_, params=None, attrs=None):
    """The same pnnx Operator in both packages' IR."""
    ops = []
    for g in (jgraph, tgraph):
        op = g.Operator(type=type_, name="t0")
        for k, v in (params or {}).items():
            op.params[k] = g.Parameter.from_value(v)
        for k, v in (attrs or {}).items():
            op.attrs[k] = g.Attribute.from_array(np.asarray(v, np.float32))
        ops.append(op)
    return ops


def run_both(type_, inputs, params=None, attrs=None, quant=False,
             dtype="float32", use_kernels=None):
    """Lower and apply in both packages; outputs as f32 numpy."""
    jop, top = make_ops(type_, params, attrs)
    jimpl = jlower(jop, JCfg(compute_dtype=dtype))
    timpl = tlower(top, TCfg(compute_dtype=dtype, device="cpu",
                             use_kernels=use_kernels))
    jw, tw = dict(jimpl.weights), dict(timpl.weights)
    if quant:
        for key, axis in timpl.quantizable.items():
            jw[key] = jquant(jw[key], axis)
            tw[key] = tquant(tw[key].numpy(), axis)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jw = {k: (v if isinstance(v, JQ) else
              jnp.asarray(v).astype(jnp.float32 if k in jimpl.fp32_keys
                                    else jd)) for k, v in jw.items()}
    tw = {k: (v if not isinstance(v, torch.Tensor) else
              v.to(torch.float32 if k in timpl.fp32_keys else td))
          for k, v in tw.items()}
    got = timpl.apply(tw, *[torch.from_numpy(x).to(td) for x in inputs])
    want = jimpl.apply(jw, *[jnp.asarray(x).astype(jd) for x in inputs])
    return (got.float().numpy(),
            np.asarray(jnp.asarray(want).astype(jnp.float32)))


def conv_params(ic, oc, k, stride=1, pad=0, dilation=1, groups=1,
                bias=True, mode="zeros", act=None, cat=False):
    k = k if isinstance(k, tuple) else (k, k)
    p = dict(padding_mode=mode, padding=[pad, pad], kernel_size=list(k),
             stride=[stride, stride], dilation=[dilation, dilation],
             groups=groups, in_channels=ic, out_channels=oc, bias=bias)
    if act:
        p["si_fused_act"] = act
    if cat:
        p["si_cat_inputs"] = True
    a = {"weight": RNG.standard_normal((oc, ic // groups, *k),
                                       dtype=np.float32) / np.sqrt(ic * k[0])}
    if bias:
        a["bias"] = RNG.standard_normal(oc, dtype=np.float32)
    return p, a


CONV_CASES = {
    "3x3_s1_p1": ((2, 8, 8, 3), dict(ic=3, oc=8, k=3, pad=1)),
    "1x1_yolo_head": ((1, 4, 4, 32), dict(ic=32, oc=33, k=1)),
    "grouped": ((2, 6, 6, 8), dict(ic=8, oc=12, k=3, pad=1, groups=4)),
    "stem_6x6_s2_p2": ((2, 16, 16, 3), dict(ic=3, oc=16, k=6, stride=2,
                                            pad=2)),
    "dilated": ((1, 9, 9, 4), dict(ic=4, oc=6, k=3, pad=2, dilation=2)),
    "no_bias": ((1, 5, 5, 4), dict(ic=4, oc=4, k=3, pad=1, bias=False)),
    "asymmetric_kernel": ((1, 7, 6, 3), dict(ic=3, oc=5, k=(1, 3))),
    "replicate": ((1, 6, 6, 3), dict(ic=3, oc=4, k=3, pad=1,
                                     mode="replicate")),
    "reflect": ((1, 6, 6, 3), dict(ic=3, oc=4, k=3, pad=2,
                                   mode="reflect")),
    "fused_silu": ((1, 6, 6, 8), dict(ic=8, oc=16, k=3, pad=1, act="silu")),
    "fused_leaky": ((1, 6, 6, 8), dict(ic=8, oc=16, k=1,
                                       act="leaky_relu@0.1")),
    "fused_hardswish_s2": ((1, 8, 8, 8), dict(ic=8, oc=8, k=3, stride=2,
                                              pad=1, act="hardswish")),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d(case):
    shape, kw = CONV_CASES[case]
    p, a = conv_params(**kw)
    x = RNG.standard_normal(shape, dtype=np.float32)
    got, want = run_both("nn.Conv2d", [x], p, a)
    np.testing.assert_allclose(got, want, **CONV_TOL)


@pytest.mark.parametrize("n_src", [2, 3])
def test_conv2d_cat_split(n_src):
    chans = [8, 4, 12][:n_src]
    p, a = conv_params(sum(chans), 16, 1, act="silu", cat=True)
    xs = [RNG.standard_normal((2, 5, 5, c), dtype=np.float32) for c in chans]
    got, want = run_both("nn.Conv2d", xs, p, a)
    np.testing.assert_allclose(got, want, **CONV_TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_pointwise_int8w(dtype, use_kernels, monkeypatch):
    """A pointwise int8w conv: through matmul_int8w (kernels on; the
    plain version on the CPU) or F.conv2d, against the JAX conv on the
    dequantized weight. f32: the conv tolerance; bf16: 2 bf16 ulps of
    the output scale (the two sides round at other places)."""
    calls = []
    orig = tmm.matmul_int8w
    monkeypatch.setattr(tmm, "matmul_int8w",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    p, a = conv_params(32, 24, 1, act="silu")
    x = RNG.standard_normal((2, 6, 6, 32), dtype=np.float32)
    got, want = run_both("nn.Conv2d", [x], p, a, quant=True, dtype=dtype,
                         use_kernels=use_kernels)
    assert len(calls) == int(use_kernels)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **CONV_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("k,s,p,d,ceil", [
    (3, 2, 1, 1, False), (5, 1, 2, 1, False), (2, 2, 0, 1, True),
    (3, 2, 1, 1, True), (3, 1, 1, 2, False)])
def test_max_pool(k, s, p, d, ceil):
    x = RNG.standard_normal((2, 9, 10, 4), dtype=np.float32)
    params = dict(ceil_mode=ceil, return_indices=False, padding=[p, p],
                  kernel_size=[k, k], stride=[s, s], dilation=[d, d])
    got, want = run_both("nn.MaxPool2d", [x], params)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [1, 2])
def test_adaptive_avg_pool(size):
    x = RNG.standard_normal((2, 4, 6, 3), dtype=np.float32)
    got, want = run_both("nn.AdaptiveAvgPool2d", [x],
                         dict(output_size=[size, size]))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("params", [
    dict(mode="nearest", scale_factor=[2.0, 2.0]),
    dict(mode="nearest", size=[7, 5]),
    dict(mode="bilinear", scale_factor=[2.0, 2.0], align_corners=False),
    dict(mode="bilinear", size=[7, 9], align_corners=True),
])
def test_upsample(params):
    x = RNG.standard_normal((2, 4, 3, 5), dtype=np.float32)
    got, want = run_both("nn.Upsample", [x], params)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("dim,shapes", [
    (1, [(2, 3, 4, 5), (2, 3, 4, 2)]),   # channels: NHWC dim 3
    (2, [(2, 3, 4, 5), (2, 1, 4, 5)]),   # height: NHWC dim 1
    (-1, [(2, 3, 4, 5), (2, 3, 2, 5)]),  # width: NHWC dim 2
    (1, [(2, 3, 4), (2, 5, 4)]),         # rank 3: no remap
])
def test_cat(dim, shapes):
    xs = [RNG.standard_normal(s, dtype=np.float32) for s in shapes]
    got, want = run_both("torch.cat", xs, dict(dim=dim))
    np.testing.assert_array_equal(got, want)


def test_flatten():
    x = RNG.standard_normal((2, 3, 4, 5), dtype=np.float32)
    got, want = run_both("torch.flatten", [x], dict(start_dim=1,
                                                      end_dim=-1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code", list(range(12)))
def test_binary_tensor(code):
    a = RNG.uniform(0.5, 2.0, (2, 3, 4, 5)).astype(np.float32)
    b = RNG.uniform(0.5, 2.0, (1, 1, 4, 5)).astype(np.float32)  # broadcast
    got, want = run_both("BinaryOp", [a, b], {"0": code})
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("code", [0, 1, 2, 3, 4, 7, 8, 9])
def test_binary_scalar(code):
    a = RNG.uniform(0.5, 2.0, (2, 3, 4, 5)).astype(np.float32)
    got, want = run_both("BinaryOp", [a], {"0": code, "1": 1, "2": 1.5})
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("code", list(range(18)))
def test_unary(code):
    x = RNG.uniform(0.1, 0.9, (2, 3, 4)).astype(np.float32)
    got, want = run_both("UnaryOp", [x], {"0": code})
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("type_", [
    "nn.ReLU", "nn.SiLU", "nn.Sigmoid", "nn.Hardsigmoid", "nn.Hardswish",
    "nn.ReLU6", "nn.Mish", "F.silu"])
def test_activation(type_):
    x = RNG.standard_normal((2, 3, 4, 5), dtype=np.float32) * 4
    got, want = run_both(type_, [x])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _detect_attrs(chans, hws, na=3, nc=4):
    """Detect attrs as zoo/builders.yolo_detect writes them."""
    no = nc + 5
    attrs = {"pnnx_5": np.asarray([8, 16, 32], np.float32)}
    for i, (c, (h, w)) in enumerate(zip(chans, hws)):
        attrs[f"m.{i}.weight"] = RNG.standard_normal(
            (na * no, c, 1, 1), dtype=np.float32) / np.sqrt(c)
        attrs[f"m.{i}.bias"] = 0.05 * RNG.standard_normal(
            na * no).astype(np.float32)
        xv, yv = np.meshgrid(np.arange(w), np.arange(h))
        grid = np.stack([xv, yv], -1).astype(np.float32) - 0.5
        attrs[f"pnnx_{(6, 3, 1)[i]}"] = np.ascontiguousarray(
            np.broadcast_to(grid[None, None], (1, na, h, w, 2)))
        ag = RNG.uniform(10, 300, (1, na, 1, 1, 2)).astype(np.float32)
        attrs[f"pnnx_{(4, 2, 0)[i]}"] = np.ascontiguousarray(
            np.broadcast_to(ag, (1, na, h, w, 2)))
    return attrs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolo_detect(dtype):
    """Decode after the concat (port) vs per level (JAX): same f32
    formulas, [N, ΣHW·A, ni] out. bf16: the head logits round to bf16 on
    both sides at other places, so 2 bf16 ulps of the output scale."""
    chans, hws = (8, 16, 32), ((8, 8), (4, 4), (2, 2))
    xs = [RNG.standard_normal((2, h, w, c), dtype=np.float32)
          for c, (h, w) in zip(chans, hws)]
    got, want = run_both("models.yolo.Detect", xs,
                         attrs=_detect_attrs(chans, hws), dtype=dtype)
    assert got.shape == want.shape == (2, 3 * (64 + 16 + 4), 9)
    scale = np.abs(want).max()
    tol = (dict(atol=2e-4 * scale, rtol=1e-4) if dtype == "float32"
           else dict(atol=2 ** -7 * scale, rtol=2 ** -7))
    np.testing.assert_allclose(got, want, **tol)


def test_unsupported_op():
    from simpleinfer_tpu_torch.ops import UnsupportedOpError

    top = make_ops("nn.NoSuchOp")[1]
    with pytest.raises(UnsupportedOpError):
        tlower(top, TCfg(device="cpu"))
