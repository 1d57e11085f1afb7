"""Static int8 in the port (simpleinfer_tpu_torch) against the JAX
package, on the CPU: quantize_act, matmul_s8s8's plain version (vs the
XLA oracle and the Pallas kernel in interpret mode), conv2d_int8_static,
the int8 nn.Linear, mark_int8_chains, calibration and its artifact, the
yolov5n int8 Engine and the detection budget of tests/test_acceptance.py.

Tolerances:
- int8 bytes and s32 accumulators: equal;
- matmul_s8s8 outputs: the epilogues are the same f32 operations, so
  rtol 1e-6 (the two libraries' activation functions may differ by an
  ulp), plus one bf16 ulp (2^-7 relative) for a bf16 output;
- calibration scales: rtol 1e-4 (fp32 sums in another order), with the
  port given the fp weights that the JAX package runs on its W-packed
  stem chain (the port quantizes those convs; unmatched, the scales
  differ by up to 1%);
- the int8 Engine on the same scales and weights, fp32: the golden
  max (5e-4 x scale) and 1e-6 x scale mean (measured 1.5e-7 / 4e-11:
  fp32 sums in another order; where an activation lies within rounding
  of a quantization boundary it takes the next int8 step on one side,
  measured 2.9e-5 / 4e-9 at other seeds).
"""
import importlib
import os
import sys
import zlib

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JCfg
from simpleinfer_tpu.config import EngineConfig as JOpCfg
from simpleinfer_tpu.ir import graph as jgraph
from simpleinfer_tpu.ir.expression import expand_expression as jexpand
from simpleinfer_tpu.ir.passes import run_inference_fusions as jfusions
from simpleinfer_tpu.ops import lower_operator as jlower
from simpleinfer_tpu.ops.conv import conv2d_int8_static as jconv8
from simpleinfer_tpu.quant.tensor import QuantizedTensor as JQ
from simpleinfer_tpu.quant.tensor import quantize_act as jquant_act
from simpleinfer_tpu.quant.tensor import quantize_per_channel as jquant
from simpleinfer_tpu.zoo import build_yolov5 as jbuild
from simpleinfer_tpu.zoo.metrics import int8_parity_report
from simpleinfer_tpu_torch import Engine, EngineConfig, EngineStateError
from simpleinfer_tpu_torch.convert import program_weights_from_numpy
from simpleinfer_tpu_torch.ir import graph as tgraph
from simpleinfer_tpu_torch.ir.expression import expand_expression as texpand
from simpleinfer_tpu_torch.ir.passes import run_inference_fusions as tfusions
from simpleinfer_tpu_torch.kernels import matmul as tmm
from simpleinfer_tpu_torch.ops import lower_operator as tlower
from simpleinfer_tpu_torch.ops.conv import conv2d_int8_static as tconv8
from simpleinfer_tpu_torch.quant.tensor import (QuantizedActivation,
                                                QuantizedTensor)
from simpleinfer_tpu_torch.quant.tensor import quantize_act as tquant_act
from simpleinfer_tpu_torch.quant.tensor import quantize_per_channel as tquant
from simpleinfer_tpu_torch.zoo import build_yolov5

# the module (the package re-exports a function of the same name)
jmm = importlib.import_module("simpleinfer_tpu.kernels.matmul")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -7
SHAPES = [(128, 128, 128), (100, 60, 50), (1, 256, 255), (37, 129, 131),
          (8, 16, 8)]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _s8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# ---- quantize_act ---------------------------------------------------------
@pytest.mark.parametrize("dtype,per_channel", [("float32", False),
                                               ("bfloat16", False),
                                               ("float32", True)])
def test_quantize_act_bytes_equal(dtype, per_channel):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 9, 7, 16)) * 3).astype(np.float32)
    x[0, 0, 0, :4] = [100.0, -100.0, 0.5 * 0.04, -1.5 * 0.04]  # saturate,
    scale = (rng.uniform(0.01, 0.1, 16) if per_channel  # and ties
             else np.float32(0.04)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jquant_act(jx, jnp.asarray(scale)))
    got = tquant_act(tx, torch.from_numpy(np.asarray(scale))).numpy()
    assert got.dtype == np.int8
    assert got.tobytes() == want.tobytes()


# ---- matmul_s8s8 ----------------------------------------------------------
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matmul_s8s8_ref_matches_jax(m, k, n):
    """The s32 sum equal to XLA's; the epilogue (scalar or per-column
    scale, bias, activation, f32 or bf16 out) within f32 rounding."""
    rng = _rng("s8", m, k, n)
    xq, wq = _s8(rng, m, k), _s8(rng, k, n)
    scale = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    acc = (torch.from_numpy(xq).double() @ torch.from_numpy(wq).double())
    jacc = np.asarray(jax.lax.dot_general(
        jnp.asarray(xq), jnp.asarray(wq), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), jacc)
    for sc, b, act, od in ((scale, bias, "silu", "float32"),
                           (np.float32(3e-4), None, None, "float32"),
                           (scale, bias, "relu", "bfloat16")):
        got = tmm.matmul_s8s8_ref(
            torch.from_numpy(xq), torch.from_numpy(wq),
            torch.from_numpy(np.asarray(sc)),
            None if b is None else torch.from_numpy(b), act,
            out_dtype=getattr(torch, od)).float().numpy()
        want = np.asarray(jmm.matmul_s8s8_ref(
            jnp.asarray(xq), jnp.asarray(wq), sc,
            None if b is None else jnp.asarray(b), act,
            out_dtype=getattr(jnp, od)).astype(jnp.float32))
        lim = 1e-6 * np.abs(want) + 1e-6 * max(1.0, np.abs(want).max())
        if od == "bfloat16":
            lim = lim + BF16_ULP * np.abs(want)
        assert (np.abs(got - want) <= lim).all()


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (37, 129, 131),
                                   (1, 256, 255)])
def test_matmul_s8s8_ref_matches_pallas_interpret(m, k, n):
    """The plain version against the Pallas kernel run in interpret
    mode, the main path's configuration (silu, bf16 out) and a scalar
    scale with f32 out (exact there: the same f32 product)."""
    rng = _rng("pallas", m, k, n)
    xq, wq = _s8(rng, m, k), _s8(rng, k, n)
    scale = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmm.matmul_s8s8(
            jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
            jnp.asarray(bias), "silu").astype(jnp.float32))
        want32 = np.asarray(jmm.matmul_s8s8(
            jnp.asarray(xq), jnp.asarray(wq), 0.01, out_dtype=jnp.float32))
    tx, tw = torch.from_numpy(xq), torch.from_numpy(wq)
    got = tmm.matmul_s8s8(tx, tw, torch.from_numpy(scale),
                          torch.from_numpy(bias), "silu").float().numpy()
    lim = (1e-6 + BF16_ULP) * np.abs(want) + 1e-6 * max(1, np.abs(want).max())
    assert (np.abs(got - want) <= lim).all()
    got32 = tmm.matmul_s8s8(tx, tw, 0.01, out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got32, want32)


def test_matmul_s8s8_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    xq, wq = (torch.from_numpy(_s8(rng, 33, 70)),
              torch.from_numpy(_s8(rng, 70, 9)))
    scale = torch.full((9,), 1e-3)
    before = tmm.launches_s8s8
    got = tmm.matmul_s8s8(xq, wq, scale, None, "silu")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tmm.matmul_s8s8_ref(xq, wq, scale, None, "silu"))
    assert tmm.launches_s8s8 == before


def test_kernels_off_s8_product_on_cpu_is_the_float64_one():
    """int8_epilogue with kernels off: matmul_s8s8_library, whose exact sum
    is torch._int_mm's s32 on the card (tests/test_torch_cuda.py holds it
    bit-equal there) and float64 on the CPU, bit-equal to
    matmul_s8s8_ref; with kernels on int8_epilogue takes the kernel's
    wrapper (its plain version on the CPU)."""
    from simpleinfer_tpu_torch.ops import conv as tconv

    rng = np.random.default_rng(9)
    xq, wq = (torch.from_numpy(_s8(rng, 40, 72)),
              torch.from_numpy(_s8(rng, 72, 24)))
    assert not tconv.int_mm_ok(xq, wq)           # the CPU: float64
    assert torch.equal(tconv.s8_product(xq, wq), xq.double() @ wq.double())
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    for scale, bias, act, od in (
            (torch.full((24,), 2e-3), b, "silu", torch.bfloat16),
            (torch.tensor(1e-3), None, None, torch.float32)):
        assert torch.equal(
            tconv.matmul_s8s8_library(xq, wq, scale, bias, act, od),
            tmm.matmul_s8s8_ref(xq, wq, scale, bias, act, od))
    act_scale, w_scale = torch.tensor(0.02), torch.full((24,), 0.01)
    for use_kernels in (True, False):
        got = tconv.int8_epilogue(xq, wq, act_scale, w_scale, b, "relu",
                                  torch.float32, use_kernels=use_kernels)
        assert torch.equal(got, tmm.matmul_s8s8_ref(
            xq, wq, act_scale * w_scale, b, "relu", torch.float32))


@pytest.mark.parametrize("m,k,n", [(37, 129, 131), (64, 1152, 256),
                                   (1, 16, 8)])
def test_s8s8_k_major_weight_gives_the_same_integers(m, k, n):
    """matmul_s8s8 and the kernels-off matmul_s8s8_library take w_q
    row-major or K-major (the [K, N] view of a contiguous [N, K], as
    Engine.place_weights lays out static-int8 weights): the same
    integers and outputs either way, and the JAX package's
    matmul_s8s8_ref on the same bytes."""
    from simpleinfer_tpu_torch.ops import conv as tconv

    rng = _rng("kmajor", m, k, n)
    xq, wq = _s8(rng, m, k), _s8(rng, k, n)
    scale = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    tx, tw = torch.from_numpy(xq), torch.from_numpy(wq)
    wk = tmm.to_k_major(tw)
    assert tmm.k_major(wk) and wk.stride() == (1, k)
    assert torch.equal(wk, tw) and tmm.to_k_major(wk) is wk
    assert tmm.k_major(tw) == (n == 1 or k == 1)
    sc, b = torch.from_numpy(scale), torch.from_numpy(bias)
    want = np.asarray(jmm.matmul_s8s8_ref(
        jnp.asarray(xq), jnp.asarray(wq), scale, jnp.asarray(bias), "silu",
        out_dtype=jnp.float32))
    lim = 1e-6 * np.abs(want) + 1e-6 * max(1.0, np.abs(want).max())
    outs = []
    for w in (tw, wk):
        assert torch.equal(tconv.s8_product(tx, w), tx.double() @ tw.double())
        got = tmm.matmul_s8s8(tx, w, sc, b, "silu", out_dtype=torch.float32)
        lib = tconv.matmul_s8s8_library(tx, w, sc, b, "silu", torch.float32)
        assert torch.equal(got, lib)
        assert (np.abs(got.numpy() - want) <= lim).all()
        outs.append(got)
    assert torch.equal(outs[0], outs[1])


def test_quantized_tensor_k_major_keeps_values():
    """QuantizedTensor.k_major: the same values, shape and scales, laid
    out so that data.reshape(-1, N) is a K-major view (HWIO conv and
    [in, out] linear weights); a tensor whose scales are not on the last
    axis is refused."""
    rng = np.random.default_rng(4)
    for shape in ((3, 3, 16, 24), (40, 12)):
        q = tquant(rng.standard_normal(shape).astype(np.float32),
                   axis=len(shape) - 1)
        km = q.k_major()
        assert torch.equal(km.data, q.data) and km.scale is q.scale
        view = km.data.reshape(-1, shape[-1])
        assert view.data_ptr() == km.data.data_ptr() and tmm.k_major(view)
        assert torch.equal(km.dequantize(), q.dequantize())
    with pytest.raises(ValueError, match="last axis"):
        tquant(rng.standard_normal((4, 6)).astype(np.float32),
               axis=0).k_major()


# ---- conv2d_int8_static ---------------------------------------------------
CONV8_CASES = [
    # (mode, stride, groups, dilation, kernel, padding)
    ("zeros", 1, 1, 1, 3, 1),
    ("zeros", 2, 1, 1, 3, 1),
    ("replicate", 1, 1, 1, 3, 1),
    ("reflect", 2, 1, 1, 3, 2),
    ("zeros", 1, 2, 1, 3, 1),
    ("reflect", 1, 4, 2, 3, 2),
    ("zeros", 1, 1, 1, 1, 0),
    ("zeros", 2, 1, 1, 6, 2),
]


@pytest.mark.parametrize("mode,stride,groups,dil,k,pad", CONV8_CASES)
def test_conv2d_int8_static_matches_jax(mode, stride, groups, dil, k, pad):
    """Unit weight scales and act_scale 1/64 make the output the s32
    accumulator times an exact power of two: equal to the JAX package's
    bit for bit. Then real scales, bias and SiLU within f32 rounding."""
    rng = _rng("conv8", mode, stride, groups, dil, k)
    ic, oc = 8, 12
    x = (rng.standard_normal((2, 11, 10, ic)) * 2).astype(np.float32)
    data = _s8(rng, k, k, ic // groups, oc)
    kw = dict(stride=(stride, stride), padding=((pad, pad), (pad, pad)),
              dilation=(dil, dil), groups=groups, padding_mode=mode)
    for wscale, bias, act in (
            (np.ones(oc, np.float32), None, None),
            (rng.uniform(1e-3, 1e-2, oc).astype(np.float32),
             rng.standard_normal(oc).astype(np.float32), "silu")):
        act_scale = np.float32(1.0 / 64)
        want = np.asarray(jconv8(
            jnp.asarray(x), JQ(data=jnp.asarray(data),
                               scale=jnp.asarray(wscale), axis=3),
            jnp.asarray(act_scale),
            None if bias is None else jnp.asarray(bias), activation=act,
            **kw))
        for use_kernels in (True, False):
            got = tconv8(
                torch.from_numpy(x),
                QuantizedTensor(data=torch.from_numpy(data),
                                scale=torch.from_numpy(wscale), axis=3),
                torch.tensor(act_scale),
                None if bias is None else torch.from_numpy(bias),
                activation=act, use_kernels=use_kernels, **kw).numpy()
            assert got.shape == want.shape
            if act is None:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_conv2d_int8_static_chain_in_and_out():
    """A QuantizedActivation input skips the quantize pass;
    out_quant_scale hands on int8 bytes equal to the JAX package's."""
    from simpleinfer_tpu.quant.tensor import QuantizedActivation as JQA

    rng = np.random.default_rng(3)
    q = _s8(rng, 1, 6, 6, 8)
    data = _s8(rng, 3, 3, 8, 5)
    wscale = rng.uniform(1e-3, 1e-2, 5).astype(np.float32)
    jout = jconv8(JQA(data=jnp.asarray(q), scale=jnp.float32(0.02)),
                  JQ(data=jnp.asarray(data), scale=jnp.asarray(wscale),
                     axis=3), None, padding=((1, 1), (1, 1)),
                  activation="silu", out_quant_scale=jnp.float32(0.05),
                  out_dtype=jnp.float32)
    tout = tconv8(QuantizedActivation(data=torch.from_numpy(q),
                                      scale=torch.tensor(0.02)),
                  QuantizedTensor(data=torch.from_numpy(data),
                                  scale=torch.from_numpy(wscale), axis=3),
                  None, padding=((1, 1), (1, 1)), activation="silu",
                  out_quant_scale=torch.tensor(0.05),
                  out_dtype=torch.float32)
    assert isinstance(tout, QuantizedActivation)
    assert tout.data.shape == (1, 6, 6, 5)
    assert tout.data.numpy().tobytes() == np.asarray(jout.data).tobytes()


# ---- nn.Linear static int8 -------------------------------------------------
def _linear_ops(k, n):
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ops = []
    for g in (jgraph, tgraph):
        op = g.Operator(type="nn.Linear", name="fc")
        for key, v in dict(in_features=k, out_features=n, bias=True).items():
            op.params[key] = g.Parameter.from_value(v)
        op.attrs["weight"] = g.Attribute.from_array(w)
        op.attrs["bias"] = g.Attribute.from_array(b)
        op.params["si_fused_act"] = g.Parameter.from_value("silu")
        ops.append(op)
    return ops


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (37, 64, 20)])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_linear_int8_matches_jax(m, k, n, use_kernels):
    """At the JAX package's Pallas gate (min(M, K, N) >= 256) and below
    it: both exact paths of the JAX package against the port's one."""
    jop, top = _linear_ops(k, n)
    jimpl = jlower(jop, JOpCfg(quant="int8"))
    timpl = tlower(top, EngineConfig(quant="int8", device="cpu",
                                     use_kernels=use_kernels))
    assert timpl.act_quant and timpl.act_fold == jimpl.act_fold
    wq = jquant(jimpl.weights["weight"], 1)
    tq = tquant(timpl.weights["weight"].numpy(), 1)
    assert tq.data.numpy().tobytes() == np.asarray(wq.data).tobytes()
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    s = np.float32(np.abs(x).max() / 127)
    want = np.asarray(jimpl.apply(
        {"weight": wq, "bias": jnp.asarray(jimpl.weights["bias"]),
         "act_scale": jnp.asarray(s)}, jnp.asarray(x)))
    calls = tmm.launches_s8s8
    got = timpl.apply({"weight": tq, "bias": timpl.weights["bias"],
                       "act_scale": torch.tensor(s)},
                      torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tmm.launches_s8s8 == calls  # CPU: the plain version


# ---- passes ---------------------------------------------------------------
def _graph_signature(graph):
    """Every op with its type, operands, params (without the JAX
    package's W-packed markers, a TPU layout means the port leaves out)
    and attr bytes."""
    sig = []
    for op in graph.ops:
        params = {k: repr(v.value) for k, v in op.params.items()
                  if k not in ("si_pack_out", "si_pack_in")}
        attrs = {k: (v.type, tuple(v.shape), bytes(v.data))
                 for k, v in op.attrs.items()}
        sig.append((op.type, op.name, [r.name for r in op.inputs],
                    [r.name for r in op.outputs], params, attrs))
    return sig


@pytest.mark.parametrize("variant,c3", [("n", False), ("l", False),
                                        ("l", True)])
def test_fusions_mark_and_fuse_like_jax(variant, c3):
    """run_inference_fusions in int8 mode (mark_int8_chains, and
    fuse_c3_blocks with c3_fusion) gives the JAX package's graph: the
    same ops, chain markers and fused-C3 attr bytes."""
    jg = jbuild(variant, batch=1, image_size=64)[0]
    tg = build_yolov5(variant, batch=1, image_size=64)[0]
    jexpand(jg)
    texpand(tg)
    jstats = jfusions(jg, JCfg(quant="int8", c3_fusion=c3))
    tstats = tfusions(tg, EngineConfig(quant="int8", c3_fusion=c3,
                                       device="cpu"))
    jstats.pop("packed_chain")
    assert tstats == jstats
    assert _graph_signature(tg) == _graph_signature(jg)
    assert tstats["int8_chain"] > 0 or c3  # C3 fusion takes every chain
    assert sum(op.type == "si.FusedC3" for op in tg.ops) == (8 if c3 else 0)


# ---- calibration ------------------------------------------------------------
def _engines(quant="int8", variant="n", batch=2, image=64, dtype="float32",
             **cfg):
    jg, in_name, out_name = jbuild(variant, batch=batch, image_size=image)
    tg = build_yolov5(variant, batch=batch, image_size=image)[0]
    je = JEngine(JCfg(quant=quant, compute_dtype=dtype, **cfg)).load_model(
        None, graph=jg)
    te = Engine(EngineConfig(quant=quant, compute_dtype=dtype, device="cpu",
                             **cfg)).load_model(None, graph=tg)
    return je, te, in_name, out_name


def _images(batch=2, image=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, image, image, 3)).astype(np.float32) / 3


def _same_weights_as_jax(je, te, in_name, variant="n", batch=2, image=64,
                         build=None):
    """Give the port's int8 engine the fp weights of the convs that the
    JAX package runs on its W-packed path (the stem and the convs that
    receive a packed input: its `bt_in*` packs are not quantized), so
    both compute the same network; ROADMAP.md §3 records the
    difference. Those convs are outside the int8 gate (ic <= 64).
    `build` makes the port's graph (default: build_yolov5 of `variant`
    at `batch` and `image`)."""
    env = je.program.wrap_inputs({in_name: jnp.zeros(
        (batch, image, image, 3), jnp.float32)})
    names = []
    for impl, ins, outs in je.program.plan:
        args = [env[n] for n in ins]
        if impl.type == "nn.Conv2d" and (
                impl.stem_pack_info is not None
                or any(type(a).__name__ == "PackedW" for a in args)):
            names.append(impl.name)
        out = impl.apply(je._device_weights[impl.name], *args)
        outs_ = [out] if impl.n_outputs == 1 else list(out)
        env.update(zip(outs, outs_))
    graph = (build() if build is not None else
             build_yolov5(variant, batch=batch, image_size=image)[0])
    fp = Engine(EngineConfig(device="cpu")).load_model(None, graph=graph)
    for name in names:
        te.program.weights[name]["weight"] = fp.program.weights[name]["weight"]
    te._device_weights = te.place_weights(te.program.weights, te.program)
    return names


@pytest.mark.parametrize("cfg", [dict(), dict(act_per_channel=True),
                                 dict(act_clip_percentile=99.9)],
                         ids=["per-tensor", "per-channel", "percentile"])
def test_calibrate_scales_match_jax(cfg):
    """The same scales as the JAX package's calibrate within rtol 1e-4
    (measured <= 7e-6: fp32 sums in another order), once the port runs
    the JAX package's fp weights on its W-packed convs."""
    je, te, in_name, _ = _engines(**cfg)
    assert len(_same_weights_as_jax(je, te, in_name)) == 8
    batches = [{in_name: _images(seed=s)} for s in (1, 2)]
    want = je.calibrate(batches)
    got = te.calibrate(batches)
    assert got.keys() == want.keys()
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape and g.dtype == np.float32, k
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=0, err_msg=k)
    if cfg.get("act_per_channel"):
        assert any(np.asarray(v).ndim == 1 for v in got.values())


def test_calibration_artifacts_cross_load(tmp_path):
    """An artifact either package saves, the other loads: the same
    scales (bytes), installed the same way (folded per-channel weights
    byte-equal)."""
    je, te, in_name, _ = _engines(act_per_channel=True)
    batches = [{in_name: _images(seed=4)}]
    je.calibrate(batches)
    te.calibrate(batches)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    je.save_calibration(jpath)
    te.save_calibration(tpath)
    j2, t2, _, _ = _engines(act_per_channel=True)
    loaded = t2.load_calibration(jpath)
    back = j2.load_calibration(tpath)
    with np.load(jpath) as z:
        assert loaded.keys() == set(z.files)
        for k in z.files:
            assert np.asarray(loaded[k]).tobytes() == z[k].tobytes()
            assert t2.program.weights[k]["act_scale"].numpy().tobytes() \
                == z[k].astype(np.float32).tobytes()
    assert back.keys() == loaded.keys()
    for name, w in t2.program.weights.items():
        if isinstance(w.get("weight"), QuantizedTensor):
            jw = je.program.weights[name]["weight"]
            assert w["weight"].data.numpy().tobytes() == \
                np.asarray(jw.data).tobytes(), name
    with pytest.raises(EngineStateError):
        Engine(EngineConfig(device="cpu", quant="int8w")).load_model(
            None, graph=build_yolov5("n", batch=1, image_size=32)[0]
        ).load_calibration(jpath)


def test_int8_engine_matches_jax_on_same_scales():
    """yolov5n-64 fp32 int8: the port on the JAX package's calibration
    artifact against the JAX engine; and the JAX program's own weights
    (act_scale, out_scale, folded bytes) carried into the port
    (program_weights_from_numpy) give the port's own output."""
    je, te, in_name, out_name = _engines()
    _same_weights_as_jax(je, te, in_name)
    je.calibrate([{in_name: _images(seed=7)}])
    te._install_act_scales({k: np.asarray(w["act_scale"])
                            for k, w in je.program.weights.items()
                            if "act_scale" in w})
    assert any("out_scale" in w for w in te.program.weights.values())
    x = _images(seed=8)
    want = np.asarray(je.run({in_name: x})[out_name])
    calls = tmm.launches_s8s8
    got = te.run({in_name: x})[out_name]
    assert tmm.launches_s8s8 == calls
    scale = max(1.0, float(np.abs(want).max()))
    d = np.abs(got - want)
    assert d.max() <= 5e-4 * scale and d.mean() <= 1e-6 * scale, \
        (d.max() / scale, d.mean() / scale)

    def numpy_tree(weights):
        return {op: {k: ((np.asarray(v.data), np.asarray(v.scale), v.axis)
                         if isinstance(v, JQ) else np.asarray(v))
                     for k, v in d.items()} for op, d in weights.items()}

    # the JAX program's weights carried over: the port's own output on
    # its own weights (those JAX runs packed are quantized here, as the
    # carried ones are)
    _, own, _, _ = _engines()
    own._install_act_scales({k: np.asarray(w["act_scale"])
                             for k, w in je.program.weights.items()
                             if "act_scale" in w})
    carried = program_weights_from_numpy(numpy_tree(je.program.weights),
                                         device="cpu")
    with torch.inference_mode():
        again = own.program.fn(own.place_weights(carried, own.program),
                               {in_name: torch.from_numpy(x)})[out_name]
    np.testing.assert_array_equal(again.numpy(),
                                  own.run({in_name: x})[out_name])


def test_config_int8_fields():
    """The int8 fields and the dispatch gate's constants carry the JAX
    package's defaults."""
    from simpleinfer_tpu_torch.ops import conv as tconv

    cfg, jcfg = EngineConfig(device="cpu", quant="int8"), JCfg(quant="int8")
    assert (cfg.act_clip_percentile, cfg.act_per_channel,
            tconv.INT8_MIN_CHANNELS, tconv.INT8_POINTWISE) == \
        (jcfg.act_clip_percentile, jcfg.act_per_channel,
         jcfg.int8_min_channels, jcfg.int8_pointwise) == \
        (None, False, 128, False)
    with pytest.raises(ValueError, match="act_clip_percentile"):
        EngineConfig(device="cpu", act_clip_percentile=100.0)
    eng = Engine(EngineConfig(device="cpu", quant="int8"))
    eng.load_model(None, graph=build_yolov5("n", batch=1, image_size=32)[0])
    with pytest.raises(EngineStateError, match="at least one batch"):
        eng.calibrate([])
    with pytest.raises(EngineStateError, match="run calibrate"):
        eng.save_calibration("unused.npz")
    with pytest.raises(EngineStateError, match="requires"):
        Engine(EngineConfig(device="cpu")).load_model(
            None, graph=build_yolov5("n", batch=1, image_size=32)[0]
        ).calibrate([{}])


def test_int8_engine_kernels_on_reach_matmul_s8s8(monkeypatch):
    """With kernels on, every calibrated conv inside the int8 gate calls
    matmul_s8s8 once per forward (on the CPU its plain version)."""
    calls = []
    orig = tmm.matmul_s8s8

    def spy(x_q, w_q, scale, *a, **kw):
        calls.append((tuple(x_q.shape), tuple(w_q.shape)))
        return orig(x_q, w_q, scale, *a, **kw)

    monkeypatch.setattr(tmm, "matmul_s8s8", spy)
    g, in_name, out_name = build_yolov5("n", batch=1, image_size=64)
    eng = Engine(EngineConfig(device="cpu", quant="int8", use_kernels=True))
    eng.load_model(None, graph=g)
    eng.calibrate([{in_name: _images(1)}])
    calls.clear()
    out = eng.run({in_name: _images(1, seed=3)})[out_name]
    eligible = [op for op in g.ops if op.type == "nn.Conv2d"
                and op.params["kernel_size"].value != [1, 1]
                and op.params["in_channels"].value >= 128]
    assert len(calls) == len(eligible) > 0
    assert np.isfinite(out).all()


@pytest.mark.parametrize("variant", ["yolov5n", "resnet18"])
def test_engine_places_static_int8_weights_k_major(variant):
    """After calibration every static-int8 weight is placed K-major once
    (OpImpl.s8_weight), every other weight keeps its layout, and the
    forward is bit-equal to one over the same weights placed row-major
    (the CPU's float64 sums do not see the layout)."""
    from simpleinfer_tpu_torch.zoo import build_resnet18

    if variant == "yolov5n":
        g, in_name, out_name = build_yolov5("n", batch=1, image_size=64)
        x = _images(1)
    else:
        g, in_name, out_name = build_resnet18(batch=1, image_size=64,
                                              width=16)
        x = _images(1, seed=2)
    eng = Engine(EngineConfig(device="cpu", quant="int8", use_kernels=True))
    eng.load_model(None, graph=g)
    eng.calibrate([{in_name: x}])
    s8_ops = {i.name for i in eng.program.impls if i.s8_weight}
    placed = eng._device_weights
    n_kmajor = 0
    for op, wd in placed.items():
        for key, w in wd.items():
            if not isinstance(w, QuantizedTensor):
                continue
            view = w.data.reshape(-1, w.data.shape[-1])
            if op in s8_ops and "act_scale" in wd and key == "weight":
                assert tmm.k_major(view) and not w.data.is_contiguous()
                n_kmajor += 1
            else:
                assert w.data.is_contiguous()
    assert n_kmajor > 0
    row_major = {op: {key: (QuantizedTensor(data=w.data.contiguous(),
                                            scale=w.scale, axis=w.axis)
                            if isinstance(w, QuantizedTensor) else w)
                      for key, w in wd.items()}
                 for op, wd in placed.items()}
    feed = {in_name: torch.from_numpy(x)}
    with torch.inference_mode():
        got = eng.program.fn(placed, feed)[out_name]
        want = eng.program.fn(row_major, feed)[out_name]
    assert torch.equal(got, want)


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per-tensor", "per-channel"])
def test_detection_budget_holds_on_port(per_channel):
    """tests/test_acceptance.py's detection budget on port engines:
    bf16 int8 vs bf16, box recall >= 0.97, mAP >= 0.75, raw delta <= 5%
    of the image (scored on numpy outputs by the JAX package's
    zoo/metrics.py)."""
    rng = np.random.default_rng(7)
    n, img = 4, 160
    g_bf, in_name, _ = build_yolov5("n", batch=n, image_size=img)
    g_q = build_yolov5("n", batch=n, image_size=img)[0]
    bf = Engine(EngineConfig(device="cpu", compute_dtype="bfloat16"))
    bf.load_model(None, graph=g_bf)
    q = Engine(EngineConfig(device="cpu", compute_dtype="bfloat16",
                            quant="int8", act_per_channel=per_channel))
    q.load_model(None, graph=g_q)
    q.calibrate([{in_name: rng.random((n, img, img, 3), np.float32)}])
    x = rng.random((n, img, img, 3), np.float32)
    rep = int8_parity_report(bf, q, x, in_name)
    assert rep.fp32_detections > 0
    assert rep.box_recall >= 0.97, str(rep)
    assert rep.map_vs_fp32 >= 0.75, str(rep)
    assert rep.max_abs_logit_delta <= 0.05 * img, str(rep)


def test_chip_smoke_int8_phase_rehearses_on_cpu():
    """chip_smoke.py's yolo_int8 phase at a tiny size on the CPU, with
    the plain versions (the card runs it at yolov5l-640-b16)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    res = chip_smoke.yolo_int8_rehearsal(torch.device("cpu"))
    assert res["output_shape"] == [2, 252, 85]
    assert res["s8s8_convs_per_forward"] == 5
    assert res["c3_kernel_blocks_per_forward"] == chip_smoke.INT8_C3_BLOCKS
    assert res["c3_s8_blocks_per_forward"] == chip_smoke.INT8_C3_S8_BLOCKS
    assert res["int8w_convs_per_forward"] == chip_smoke.INT8_INT8W_CONVS
    # on a CPU tensor c3_block runs the plain version too
    assert res["c3_plain_blocks_per_forward"] == \
        chip_smoke.INT8_C3_PLAIN_BLOCKS + chip_smoke.INT8_C3_BLOCKS
    assert set(res["vs_kernels_off"]) == {"box", "scores"}
