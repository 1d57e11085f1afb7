"""The CNN classification / segmentation family in the port
(simpleinfer_tpu_torch) against the JAX package, on the CPU: the ops of
ops/norm.py (BatchNorm2d, GroupNorm, InstanceNorm2d), ops/extra.py and
ops/functional.py, the eight CNN builders (ConvNeXt, MobileNetV3 and
SqueezeNet against the JAX Engine in fp32 and int8w), their goldens (and the vit,
bert and gemma2-ish llama goldens through the port), the int8
classification budget of tests/test_acceptance.py, the classification
pipeline, and chip_smoke.py's conv_kernels and resnet_int8 phases at a
tiny size.

Tolerances, with scale = max(1, max|ref|):
- shape and copy ops (chunk, split, permute, transpose, reshape / view,
  squeeze, unsqueeze, stack, padding, slicing, expand, constants, max
  pool, nearest upsample, clamp, identities): bit-equal;
- arithmetic ops (average pools, reductions, activations, softmax,
  bilinear upsample): 1e-5 x scale (f32 sums in another order);
- norms and ConvTranspose2d: 1e-4 x scale (longer f32 sums);
- goldens and whole fp32 models against the JAX Engine: the golden
  tolerance of tests/test_golden.py (atol 5e-4 x scale, rtol 5e-4);
- int8 budget: top-1 agreement >= 0.995 with the fp32 engine
  (tests/test_acceptance.py's TOP1_BUDGET).
"""
import os
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JCfg
from simpleinfer_tpu.config import EngineConfig as JOpCfg
from simpleinfer_tpu.ir import graph as jgraph
from simpleinfer_tpu.ops import lower_operator as jlower
from simpleinfer_tpu.zoo import builders as jbuilders
from simpleinfer_tpu.zoo.classify import classify_images as jclassify
from simpleinfer_tpu.zoo.classify import preprocess_classify as jpre
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.config import EngineConfig as TCfg
from simpleinfer_tpu_torch.ir import graph as tgraph
from simpleinfer_tpu_torch.ops import lower_operator as tlower
from simpleinfer_tpu_torch.zoo import builders as tbuilders
from simpleinfer_tpu_torch.zoo.classify import classify_images, top_k
from simpleinfer_tpu_torch.zoo.classify import preprocess_classify
from simpleinfer_tpu_torch.zoo.common import fetch_nhwc, stage_for_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
RNG = np.random.default_rng(11)
TOP1_BUDGET = 0.995


def make_ops(type_, params=None, attrs=None, n_out=1):
    """The same pnnx Operator in both packages' IR, with n_out outputs."""
    ops = []
    for g in (jgraph, tgraph):
        op = g.Operator(type=type_, name="t0")
        for k, v in (params or {}).items():
            op.params[k] = g.Parameter.from_value(v)
        for k, v in (attrs or {}).items():
            op.attrs[k] = g.Attribute.from_array(np.asarray(v, np.float32))
        for j in range(n_out):
            op.outputs.append(g.Operand(name=f"o{j}"))
        ops.append(op)
    return ops


def run_both(type_, inputs, params=None, attrs=None, n_out=1,
             dtype="float32"):
    """Lower and apply in both packages; a list of f32 numpy outputs
    each (one per op output)."""
    jop, top = make_ops(type_, params, attrs, n_out)
    jimpl = jlower(jop, JOpCfg(compute_dtype=dtype))
    timpl = tlower(top, TCfg(compute_dtype=dtype, device="cpu"))
    assert timpl.n_outputs == jimpl.n_outputs
    jw = {k: jnp.asarray(v).astype(getattr(jnp, dtype))
          for k, v in jimpl.weights.items()}
    tw = {k: v.to(getattr(torch, dtype)) for k, v in timpl.weights.items()}
    got = timpl.apply(tw, *[torch.from_numpy(x).to(getattr(torch, dtype))
                            for x in inputs])
    want = jimpl.apply(jw, *[jnp.asarray(x).astype(getattr(jnp, dtype))
                             for x in inputs])
    if jimpl.n_outputs == 1:
        got, want = [got], [want]
    return ([g.float().numpy() for g in got],
            [np.asarray(jnp.asarray(w).astype(jnp.float32)) for w in want])


def assert_equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def assert_close(got, want, rel):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0)


def x4(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


# ---- norms -------------------------------------------------------------------
def bn_attrs(c):
    return {"running_mean": RNG.standard_normal(c) * 0.1,
            "running_var": RNG.uniform(0.5, 1.5, c),
            "weight": 1.0 + 0.1 * RNG.standard_normal(c),
            "bias": RNG.standard_normal(c) * 0.1}


def test_batch_norm_2d_folds_like_jax():
    """The float64 fold gives the JAX package's scale and shift bit for
    bit; the apply within the norm tolerance."""
    c = 12
    attrs = bn_attrs(c)
    params = dict(affine=True, eps=1e-5, num_features=c)
    jop, top = make_ops("nn.BatchNorm2d", params, attrs)
    jw = jlower(jop, JOpCfg()).weights
    tw = tlower(top, TCfg(device="cpu")).weights
    assert jw.keys() == tw.keys() == {"scale", "shift"}
    for k in jw:
        assert tw[k].numpy().tobytes() == np.asarray(jw[k]).tobytes()
    got, want = run_both("nn.BatchNorm2d", [x4(2, 5, 6, c)], params, attrs)
    assert_close(got, want, 1e-4)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", [(2, 5, 6, 12), (2, 7, 12)])
def test_group_norm(affine, shape):
    c = shape[-1]
    attrs = ({"weight": 1.0 + 0.1 * RNG.standard_normal(c),
              "bias": 0.1 * RNG.standard_normal(c)} if affine else {})
    got, want = run_both("nn.GroupNorm", [x4(*shape) * 3 + 1],
                         dict(num_groups=4, num_channels=c, eps=1e-5,
                              affine=affine), attrs)
    assert_close(got, want, 1e-4)


@pytest.mark.parametrize("running", [False, True])
def test_instance_norm_2d(running):
    c = 6
    attrs = {"weight": 1.0 + 0.1 * RNG.standard_normal(c),
             "bias": 0.1 * RNG.standard_normal(c)}
    if running:
        attrs.update(running_mean=RNG.standard_normal(c) * 0.1,
                     running_var=RNG.uniform(0.5, 1.5, c))
    got, want = run_both("nn.InstanceNorm2d", [x4(2, 5, 7, c) * 2],
                         dict(num_features=c, eps=1e-5, affine=True), attrs)
    assert_close(got, want, 1e-4)


def test_group_norm_rejects_indivisible():
    top = make_ops("nn.GroupNorm", dict(num_groups=5, num_channels=12,
                                        eps=1e-5, affine=False))[1]
    with pytest.raises(ValueError, match="divisible"):
        tlower(top, TCfg(device="cpu"))


# ---- pools ---------------------------------------------------------------------
@pytest.mark.parametrize("k,s,p,ceil,cip", [
    (2, 2, 0, False, True), (3, 2, 1, False, True), (3, 2, 1, True, True),
    (3, 2, 1, True, False), (3, 1, 1, False, False), (2, 3, 0, True, True)])
def test_avg_pool_2d(k, s, p, ceil, cip):
    params = dict(kernel_size=[k, k], stride=[s, s], padding=[p, p],
                  ceil_mode=ceil, count_include_pad=cip)
    x = x4(2, 9, 10, 4)
    assert_close(*run_both("nn.AvgPool2d", [x], params), 1e-5)
    fparams = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
                   count_include_pad=cip)
    assert_close(*run_both("F.avg_pool2d", [x], fparams), 1e-5)


def test_functional_pools():
    x = x4(2, 8, 9, 3)
    assert_equal(*run_both("F.max_pool2d", [x], dict(
        kernel_size=3, stride=2, padding=1, ceil_mode=True)))
    assert_equal(*run_both("F.max_pool2d", [x], dict(kernel_size=[2, 2])))
    x = x4(2, 8, 6, 3)
    assert_close(*run_both("F.adaptive_avg_pool2d", [x],
                           dict(output_size=1)), 1e-5)
    assert_close(*run_both("F.adaptive_avg_pool2d", [x],
                           dict(output_size=[4, 3])), 1e-5)


# ---- chunk / split and the NCHW -> NHWC dim remap ---------------------------
@pytest.mark.parametrize("shape,dim,chunks", [
    ((2, 4, 5, 6), 1, 3), ((2, 4, 5, 6), 2, 2), ((2, 4, 5, 6), -1, 5),
    ((2, 4, 5, 6), 3, 4), ((3, 7, 6), 1, 3), ((3, 7, 6), -1, 2)])
def test_chunk(shape, dim, chunks):
    size = shape[dim] if len(shape) != 4 else \
        (shape[0], shape[3], shape[1], shape[2])[dim]
    per = -(-size // chunks)
    n_out = -(-size // per)
    assert_equal(*run_both("torch.chunk", [x4(*shape)],
                           dict(chunks=chunks, dim=dim), n_out=n_out))


@pytest.mark.parametrize("sections,dim", [(2, 1), ([1, 3, 2], 1),
                                          ([2, 3], 2), (4, -1)])
def test_split(sections, dim):
    x = x4(2, 5, 7, 6)  # logical [2, 6, 5, 7]
    size = (2, 6, 5, 7)[dim]
    n_out = (len(sections) if isinstance(sections, list)
             else -(-size // sections))
    assert_equal(*run_both("torch.split", [x],
                           dict(split_size_or_sections=sections, dim=dim),
                           n_out=n_out))


def test_chunk_declares_its_outputs():
    top = make_ops("torch.chunk", dict(chunks=4, dim=1), n_out=4)[1]
    impl = tlower(top, TCfg(device="cpu"))
    with pytest.raises(ValueError, match="declares"):
        impl.apply({}, torch.zeros(1, 2, 2, 6))  # 6 -> 3 chunks of 2


# ---- permute / transpose / reshape / squeeze / stack --------------------------
@pytest.mark.parametrize("type_,params,shape", [
    ("torch.permute", dict(dims=[0, 2, 3, 1]), (2, 3, 4, 5)),
    ("torch.permute", dict(dims=[0, 2, 1]), (2, 3, 4)),
    ("torch.transpose", dict(dim0=1, dim1=2), (2, 3, 4, 5)),
    ("torch.transpose", dict(dim0=-1, dim1=-2), (2, 3, 4)),
    ("torch.reshape", dict(shape=[2, 5, 12]), (2, 3, 4, 5)),
    ("Tensor.view", dict(shape=[2, 20, 1, 3]), (2, 3, 4, 5)),
    ("Tensor.reshape", dict(shape=[2, 3, 4, 5]), (2, 12, 5)),
    ("torch.squeeze", dict(dim=1), (2, 3, 4, 1)),
    ("torch.squeeze", {}, (2, 1, 1, 5)),
    ("torch.unsqueeze", dict(dim=1), (2, 3, 4)),
    ("torch.unsqueeze", dict(dim=-1), (2, 3, 4, 5)),
])
def test_layout_ops(type_, params, shape):
    assert_equal(*run_both(type_, [x4(*shape)], params))


@pytest.mark.parametrize("shape,dim", [((2, 3, 4, 5), 1), ((2, 3, 4, 5), -1),
                                       ((2, 3, 4), 0), ((3, 4), 1)])
def test_stack(shape, dim):
    xs = [x4(*shape) for _ in range(3)]
    assert_equal(*run_both("torch.stack", xs, dict(dim=dim)))


# ---- reductions ------------------------------------------------------------------
@pytest.mark.parametrize("type_", ["torch.mean", "torch.sum", "torch.amax"])
@pytest.mark.parametrize("dims,keep", [([2, 3], True), ([2], False),
                                       ([1], False), ([1, 3], False),
                                       ([-1], True)])
def test_reductions(type_, dims, keep):
    got, want = run_both(type_, [x4(2, 3, 4, 5)], dict(dim=dims,
                                                       keepdim=keep))
    assert_close(got, want, 1e-5)


def test_reduction_rank3():
    assert_close(*run_both("torch.mean", [x4(2, 3, 4)], dict(dim=[1])), 1e-5)


# ---- activations and softmax -------------------------------------------------
@pytest.mark.parametrize("type_,params", [
    ("nn.LeakyReLU", dict(negative_slope=0.2)), ("nn.LeakyReLU", {}),
    ("F.leaky_relu", dict(negative_slope=0.1)),
    ("nn.ELU", dict(alpha=0.7)), ("F.elu", {}),
    ("nn.GELU", {}), ("nn.GELU", dict(approximate="tanh")), ("F.gelu", {}),
    ("nn.Tanh", {}), ("F.tanh", {}),
    ("nn.Softmax", dict(dim=1)), ("nn.Softmax", dict(dim=-1)),
    ("F.softmax", dict(dim=2)),
])
def test_activations(type_, params):
    x = x4(2, 3, 4, 5) * 3
    assert_close(*run_both(type_, [x], params), 1e-5)


def test_prelu():
    c = 5
    got, want = run_both("nn.PReLU", [x4(2, 3, 4, c)],
                         dict(num_parameters=c),
                         {"weight": RNG.uniform(0.05, 0.3, c)})
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("params", [dict(min=-0.5, max=0.7), dict(min=0),
                                    dict(max=1.5), {}])
def test_clamp(params):
    assert_equal(*run_both("torch.clamp", [x4(2, 3, 4, 5)], params))


# ---- padding --------------------------------------------------------------------
def test_zero_pad_2d():
    assert_equal(*run_both("nn.ZeroPad2d", [x4(2, 4, 5, 3)],
                           dict(padding=[1, 2, 3, 0])))


@pytest.mark.parametrize("mode,pad,shape", [
    ("constant", [1, 2, 0, 3], (2, 4, 5, 3)),
    ("constant", [1, 1, 0, 0, 2, 1], (2, 4, 5, 3)),
    ("replicate", [2, 1, 1, 2], (2, 4, 5, 3)),
    ("reflect", [2, 1, 1, 2], (2, 4, 5, 3)),
    ("reflect", [1, 2], (2, 6, 5)),
])
def test_f_pad(mode, pad, shape):
    params = dict(pad=pad, mode=mode)
    if mode == "constant":
        params["value"] = 0.5
    assert_equal(*run_both("F.pad", [x4(*shape)], params))


# ---- ConvTranspose2d -------------------------------------------------------
@pytest.mark.parametrize("k,s,p,opad,d,bias", [
    (2, 2, 0, 0, 1, True), (3, 2, 1, 1, 1, True), (3, 1, 1, 0, 2, False),
    (4, 2, 1, 0, 1, True)])
def test_conv_transpose_2d(k, s, p, opad, d, bias):
    ic, oc = 6, 5
    attrs = {"weight": RNG.standard_normal((ic, oc, k, k)) / np.sqrt(ic * k)}
    if bias:
        attrs["bias"] = RNG.standard_normal(oc)
    params = dict(in_channels=ic, out_channels=oc, kernel_size=[k, k],
                  stride=[s, s], padding=[p, p], output_padding=[opad, opad],
                  dilation=[d, d], groups=1, bias=bias)
    got, want = run_both("nn.ConvTranspose2d", [x4(2, 5, 6, ic)], params,
                         attrs)
    assert_close(got, want, 1e-4)


def test_conv_transpose_2d_same_weight_layout():
    """The flipped HWIO weight under the JAX package's key, so
    quantization and convert.py line up one to one."""
    ic, oc = 4, 3
    attrs = {"weight": RNG.standard_normal((ic, oc, 2, 2)),
             "bias": RNG.standard_normal(oc)}
    params = dict(in_channels=ic, out_channels=oc, kernel_size=[2, 2],
                  stride=[2, 2], padding=[0, 0], groups=1, bias=True)
    jop, top = make_ops("nn.ConvTranspose2d", params, attrs)
    jimpl, timpl = jlower(jop, JOpCfg()), tlower(top, TCfg(device="cpu"))
    assert timpl.quantizable == jimpl.quantizable
    for k, v in jimpl.weights.items():
        assert timpl.weights[k].numpy().tobytes() == np.asarray(v).tobytes()


# ---- constants, slicing, expand, interpolate, no-ops ------------------------------
@pytest.mark.parametrize("shape", [(1, 3, 4, 5), (2, 7)])
def test_pnnx_attribute(shape):
    assert_equal(*run_both("pnnx.Attribute", [], {},
                           {"data": RNG.standard_normal(shape)}))


@pytest.mark.parametrize("params", [
    dict(dim=1, start=1, end=4, step=2), dict(dim=2, start=-3),
    dict(dim=3, end=-1), dict(dim=0, start=1),
    dict(dims=[1, 3], starts=[0, 1], ends=[2, 2 ** 63 - 1], steps=[1, 2]),
    dict(dims=[-2], starts=[1], ends=[3])])
def test_tensor_slice(params):
    assert_equal(*run_both("Tensor.slice", [x4(2, 5, 6, 4)], params))


def test_tensor_slice_rank3():
    assert_equal(*run_both("Tensor.slice", [x4(2, 5, 6)],
                           dict(dim=1, start=1, end=4)))


@pytest.mark.parametrize("shape,target", [((2, 1, 4, 1), [2, 3, 5, -1]),
                                          ((1, 4), [3, -1])])
def test_tensor_expand(shape, target):
    assert_equal(*run_both("Tensor.expand", [x4(*shape)],
                           dict(shape=target)))


@pytest.mark.parametrize("type_,params", [
    ("F.interpolate", dict(scale_factor=2.0, mode="nearest")),
    ("F.interpolate", dict(size=[7, 5], mode="bilinear",
                           align_corners=True)),
    ("F.upsample", dict(scale_factor=[2.0, 3.0])),
    ("F.upsample_nearest", dict(size=[8, 9])),
    ("F.upsample_bilinear", dict(scale_factor=2.0, align_corners=False)),
])
def test_interpolate(type_, params):
    assert_close(*run_both(type_, [x4(2, 4, 3, 5)], params), 1e-5)


@pytest.mark.parametrize("type_", ["nn.Identity", "nn.Dropout",
                                   "nn.Dropout2d", "F.dropout",
                                   "F.dropout2d", "Tensor.contiguous",
                                   "torch.clone"])
def test_inference_no_ops(type_):
    assert_equal(*run_both(type_, [x4(2, 3, 4, 5)]))


def test_interpolate_rejects_linear():
    top = make_ops("F.interpolate", dict(scale_factor=2.0, mode="linear"))[1]
    with pytest.raises(ValueError, match="mode"):
        tlower(top, TCfg(device="cpu"))


# ---- builders ------------------------------------------------------------------
BUILDERS = {
    "resnet18": ("build_resnet18", dict(batch=2, image_size=32,
                                        num_classes=7, width=8)),
    "resnet50": ("build_resnet50", dict(batch=1, image_size=32,
                                        num_classes=5, width=8)),
    "mobilenet": ("build_mobilenet_like", dict(batch=1, image_size=32,
                                               num_classes=6,
                                               width_mult=0.5)),
    "densenet": ("build_densenet", dict(variant=(2, 2), batch=1,
                                        image_size=32, num_classes=6,
                                        growth_rate=4, init_width=8)),
    "unet": ("build_unet", dict(batch=1, image_size=32, num_classes=4,
                                width=8, depth=2)),
}
# the rest of the zoo (no golden files): ConvNeXt "atto" at 64 px,
# MobileNetV3 at width 0.5, SqueezeNet at 64 px; chip_smoke.py's zoo_rest
# phase runs them at full width (FULL_WIDTH)
ZOO_REST = {
    "convnext_atto": ("build_convnext", dict(variant="atto", batch=1,
                                             image_size=64, num_classes=6)),
    "mobilenet_v3": ("build_mobilenet_v3_like", dict(
        batch=1, image_size=64, num_classes=6, width_mult=0.5)),
    "squeezenet": ("build_squeezenet", dict(batch=1, image_size=64,
                                            num_classes=6)),
}
FULL_WIDTH = {"resnet50": dict(batch=1, image_size=224, num_classes=1000),
              "convnext_atto": dict(variant="tiny", batch=1, image_size=224),
              "mobilenet_v3": dict(batch=1, image_size=224),
              "squeezenet": dict(batch=1, image_size=224)}


@pytest.mark.parametrize("name", sorted(BUILDERS) + sorted(ZOO_REST))
def test_builder_graph_identical(name, tmp_path):
    """The same .pnnx.param text and .bin bytes as the JAX builder (the
    golden configurations, and at batch 1 the full-width ResNet-50 of
    chip_smoke.py's resnet_int8 phase and ConvNeXt-T / MobileNetV3 /
    SqueezeNet of its zoo_rest phase)."""
    fn, kw = {**BUILDERS, **ZOO_REST}[name]
    cases = [kw]
    if name in FULL_WIDTH:
        cases.append(FULL_WIDTH[name])
    for i, kw in enumerate(cases):
        tg, ti, to = getattr(tbuilders, fn)(**kw)
        jg, ji, jo = getattr(jbuilders, fn)(**kw)
        assert (ti, to) == (ji, jo)
        paths = []
        for pkg, g in (("port", tg), ("jax", jg)):
            p = (str(tmp_path / f"{pkg}{i}.pnnx.param"),
                 str(tmp_path / f"{pkg}{i}.pnnx.bin"))
            g.save(*p)
            paths.append(p)
        for a, b in zip(*paths):
            assert open(a, "rb").read() == open(b, "rb").read(), a


# the transformer goldens of tests/test_golden.py (their _cases): the
# encoders' nn.MultiheadAttention / torch.select and the gemma2-ish
# llama's attn_scale, softcap and alternate sliding layers
GOLDEN_EXTRA = {
    "vit": ("build_vit", dict(variant="tiny", batch=1, image_size=32,
                              patch_size=8, num_classes=6, depth=2,
                              embed_dim=32, num_heads=4)),
    "bert": ("build_bert", dict(variant="tiny", batch=2, seq_len=16,
                                vocab_size=64, num_classes=4, depth=2,
                                hidden=32, num_heads=4)),
    "llama_gemma2ish": ("build_llama", dict(
        variant="nano", batch=1, seq_len=16, vocab_size=32, attn_scale=0.3,
        logit_softcap=25.0, sliding_window=5, sliding_pattern="alternate",
        seed=4)),
}


def golden_input(kw):
    """tests/test_golden.py's input: token ids for a text model, else a
    seeded image batch."""
    rng = np.random.default_rng(1234)
    if "seq_len" in kw:
        return rng.integers(0, kw["vocab_size"], size=(
            kw.get("batch", 1), kw["seq_len"])).astype(np.float32)
    size = kw["image_size"]
    return rng.standard_normal(
        (kw.get("batch", 1), size, size, 3)).astype(np.float32) / 3


def golden_close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)


@pytest.mark.parametrize("name", sorted(BUILDERS) + sorted(GOLDEN_EXTRA))
def test_golden_through_port(name):
    """tests/golden/<name>.npz through the port (the inputs of
    tests/test_golden.py), and the port against the JAX Engine."""
    fn, kw = {**BUILDERS, **GOLDEN_EXTRA}[name]
    x = golden_input(kw)
    g, in_name, out_name = getattr(tbuilders, fn)(**kw)
    got = Engine(EngineConfig(device="cpu")).load_model(
        None, graph=g).run({in_name: x})[out_name]
    golden_close(got, np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["out"])
    jg = getattr(jbuilders, fn)(**kw)[0]
    want = np.asarray(JEngine().load_model(None, graph=jg).run(
        {in_name: x})[out_name])
    golden_close(got, want)


@pytest.mark.parametrize("quant", [None, "int8w"])
@pytest.mark.parametrize("name", sorted(ZOO_REST))
def test_zoo_rest_matches_jax(name, quant):
    """ConvNeXt, MobileNetV3 and SqueezeNet fp32 through the port against
    the JAX Engine, with and without weight-only int8, within the golden
    tolerance (on the golden input of tests/test_golden.py's kind)."""
    fn, kw = ZOO_REST[name]
    x = golden_input(kw)
    g, in_name, out_name = getattr(tbuilders, fn)(**kw)
    got = Engine(EngineConfig(device="cpu", quant=quant)).load_model(
        None, graph=g).run({in_name: x})[out_name]
    jg = getattr(jbuilders, fn)(**kw)[0]
    want = np.asarray(JEngine(JCfg(quant=quant)).load_model(
        None, graph=jg).run({in_name: x})[out_name])
    assert np.isfinite(got).all()
    golden_close(got, want)


@pytest.mark.parametrize("name,dtype", [("densenet", "bfloat16"),
                                        ("unet", "bfloat16")])
def test_bf16_matches_jax(name, dtype):
    """bf16 forwards: the two packages round to bf16 at other places in
    each layer, so max |diff| <= 2^-4 x scale and mean <= 2^-8 x scale."""
    fn, kw = BUILDERS[name]
    x = golden_input(kw)
    g, in_name, out_name = getattr(tbuilders, fn)(**kw)
    got = Engine(EngineConfig(device="cpu", compute_dtype=dtype)).load_model(
        None, graph=g).run({in_name: x})[out_name]
    jg = getattr(jbuilders, fn)(**kw)[0]
    want = np.asarray(JEngine(JCfg(compute_dtype=dtype)).load_model(
        None, graph=jg).run({in_name: x})[out_name], np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    d = np.abs(got - want)
    assert d.max() <= 2 ** -4 * scale and d.mean() <= 2 ** -8 * scale


def test_densenet_pre_activation_bn_runs_as_an_op():
    """DenseNet's BN after a cat stays an op after fusion (fuse_conv_bn
    folds only BNs that follow a conv) and takes the port's lowering."""
    fn, kw = BUILDERS["densenet"]
    eng = Engine(EngineConfig(device="cpu")).load_model(
        None, graph=getattr(tbuilders, fn)(**kw)[0])
    assert sum(i.type == "nn.BatchNorm2d" for i in eng.program.impls) >= 4


# ---- int8 classification budget -------------------------------------------------
def _int8_cfg(per_channel, device="cpu"):
    return EngineConfig(compute_dtype="bfloat16", quant="int8",
                        act_per_channel=per_channel, device=device)


def _budget_data():
    rng = np.random.default_rng(11)  # tests/test_acceptance.py's data
    n, img = 64, 32
    calib = rng.standard_normal((n, img, img, 3)).astype(np.float32)
    x = rng.standard_normal((n, img, img, 3)).astype(np.float32)
    return calib, x


RN18 = dict(batch=64, image_size=32, num_classes=100, width=16)


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per-tensor", "per-channel"])
def test_classification_int8_top1_within_budget_on_port(per_channel):
    """tests/test_acceptance.py's classification budget on port engines:
    bf16 int8 ResNet-18 against the fp32 engine, top-1 >= 0.995."""
    calib, x = _budget_data()
    g_fp, in_name, out_name = tbuilders.build_resnet18(**RN18)
    fp = Engine(EngineConfig(device="cpu")).load_model(None, graph=g_fp)
    q = Engine(_int8_cfg(per_channel)).load_model(
        None, graph=tbuilders.build_resnet18(**RN18)[0])
    q.calibrate([{in_name: calib}])
    ref = fp.run({in_name: x})[out_name].argmax(-1)
    got = q.run({in_name: x})[out_name].argmax(-1)
    assert float(np.mean(ref == got)) >= TOP1_BUDGET


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per-tensor", "per-channel"])
def test_classification_int8_budget_on_jax_scales(per_channel):
    """Port int8 engines on the JAX engine's weights and calibration
    scales (the convs the JAX package runs on its W-packed path get its
    fp weights, as tests/test_torch_int8.py's _same_weights_as_jax does):
    the budget against the fp32 engine, and top-1 equal to the JAX int8
    engine's within the same budget."""
    from test_torch_int8 import _same_weights_as_jax

    calib, x = _budget_data()
    jg, in_name, out_name = jbuilders.build_resnet18(**RN18)
    je = JEngine(JCfg(compute_dtype="bfloat16", quant="int8",
                      act_per_channel=per_channel)).load_model(None, graph=jg)
    te = Engine(_int8_cfg(per_channel)).load_model(
        None, graph=tbuilders.build_resnet18(**RN18)[0])
    packed = _same_weights_as_jax(je, te, in_name, batch=64, image=32,
                                  build=lambda: tbuilders.build_resnet18(
                                      **RN18)[0])
    assert packed, "the JAX package runs the stem on its W-packed path"
    je.calibrate([{in_name: calib}])
    te._install_act_scales({k: np.asarray(w["act_scale"])
                            for k, w in je.program.weights.items()
                            if "act_scale" in w})
    for name, w in te.program.weights.items():
        jw = je.program.weights[name].get("weight")
        if hasattr(jw, "data") and name not in packed:
            assert w["weight"].data.numpy().tobytes() == \
                np.asarray(jw.data).tobytes(), name
    fp = Engine(EngineConfig(device="cpu")).load_model(
        None, graph=tbuilders.build_resnet18(**RN18)[0])
    ref = fp.run({in_name: x})[out_name].argmax(-1)
    got = te.run({in_name: x})[out_name].argmax(-1)
    jgot = np.asarray(je.run({in_name: x})[out_name]).argmax(-1)
    assert float(np.mean(ref == got)) >= TOP1_BUDGET
    assert float(np.mean(jgot == got)) >= TOP1_BUDGET


# ---- classification pipeline ---------------------------------------------------------
def test_classify_images_matches_jax():
    """classify_images on HWC uint8 images of several sizes: the same
    preprocessing (within f32 rounding), the same top-k classes and
    probabilities within the golden tolerance, fp32 ResNet-18."""
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((40, 50, 3), (64, 48, 3), (33, 33, 3))]
    for im in images:
        np.testing.assert_allclose(preprocess_classify(im, 32),
                                   jpre(im, 32), rtol=1e-6, atol=1e-5)
    kw = dict(batch=3, image_size=32, num_classes=10, width=8)
    g, in_name, _ = tbuilders.build_resnet18(**kw)
    eng = Engine(EngineConfig(device="cpu")).load_model(None, graph=g)
    je = JEngine().load_model(None, graph=jbuilders.build_resnet18(**kw)[0])
    got = classify_images(eng, images, size=32, k=3)
    want = jclassify(je, images, size=32, k=3)
    assert [[c for c, _ in r] for r in got] == [[c for c, _ in r]
                                                 for r in want]
    for r, w in zip(got, want):
        np.testing.assert_allclose([p for _, p in r], [p for _, p in w],
                                   atol=5e-4, rtol=5e-4)


def test_top_k_and_nchw_staging():
    logits = np.asarray([[0.0, 2.0, 1.0], [3.0, 1.0, 2.0]], np.float32)
    assert [[c for c, _ in r] for r in top_k(logits, 2)] == [[1, 2], [0, 2]]
    g, in_name, out_name = tbuilders.build_unet(batch=1, image_size=16,
                                                num_classes=3, width=4,
                                                depth=1)
    eng = Engine(EngineConfig(device="cpu", io_layout="nchw")).load_model(
        None, graph=g)
    x = np.random.default_rng(0).standard_normal((1, 16, 16, 3)).astype(
        np.float32)
    eng.input(in_name, stage_for_engine(eng, x))
    eng.forward()
    out = fetch_nhwc(eng, out_name)
    dev = fetch_nhwc(eng, out_name, as_numpy=False)
    assert out.shape == (1, 16, 16, 3) and tuple(dev.shape) == out.shape
    np.testing.assert_array_equal(dev.numpy(), out)


# ---- chip_smoke rehearsal ---------------------------------------------------------
def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_chip_smoke_conv_kernels_phase_rehearses_on_cpu():
    """chip_smoke.py's conv_kernels phase at a tiny size on the CPU (the
    wrappers run their plain versions): every distinct 3x3 s1 shape of
    ResNet-50 and YOLOv5s at 64 px, ragged shapes, the YOLOv5s stem."""
    cs = _chip_smoke()
    convs = cs.conv3x3_main_convs(models=(
        ("resnet50", dict(batch=1, image_size=64), "relu"),
        ("yolov5s", dict(variant="s", batch=1, image_size=64), "silu")))
    assert [c[2:7] for c in convs] == [
        (16, 16, 64, 64, "relu"), (8, 8, 128, 128, "relu"),
        (4, 4, 256, 256, "relu"), (2, 2, 512, 512, "relu"),
        (16, 16, 32, 32, "silu"), (8, 8, 64, 64, "silu"),
        (4, 4, 128, 128, "silu"), (2, 2, 256, 256, "silu")]
    entries = cs.conv_kernels_phase(torch.device("cpu"), convs=convs,
                                    stem_cases=((1, "s"),))
    assert set(entries) == {"conv3x3_s1_same", "stem_s2d"}
    assert all(e["route"] == "cuda" for e in entries.values())


def test_chip_smoke_resnet_int8_phase_rehearses_on_cpu():
    """chip_smoke.py's resnet_int8 main path at 64 px on the CPU: 33
    matmul_int8w and 14 matmul_s8s8 calls per forward (the plain
    versions here), logits [2, 1000], on vs off inside its limits."""
    cs = _chip_smoke()
    res = cs.resnet_int8_rehearsal(torch.device("cpu"))
    assert res["int8w_calls_per_forward"] == cs.RESNET_INT8W_CONVS == 33
    assert res["s8s8_calls_per_forward"] == cs.RESNET_S8S8_CALLS == 14
    assert res["s8s8_conv_calls_per_forward"] == 13
    assert res["output_shape"] == [2, 1000]


# ---- carrying the JAX program's weights ------------------------------------------
@pytest.mark.parametrize("name,quant", [(n, None) for n in sorted(BUILDERS)]
                         + [("unet", "int8w"), ("densenet", "int8w")])
def test_jax_program_weights_run_in_port(name, quant):
    """A JAX Program.weights tree of each builder's graph (BatchNorm
    scale / shift, the flipped ConvTranspose2d weight, conv weights
    int8w-quantized or not) carried by convert.program_weights_from_numpy
    has the port's keys and gives the port's own output bit for bit."""
    from simpleinfer_tpu.quant.tensor import QuantizedTensor as JQ
    from simpleinfer_tpu_torch.convert import program_weights_from_numpy

    fn, kw = BUILDERS[name]
    x = golden_input(kw)
    je = JEngine(JCfg(quant=quant)).load_model(
        None, graph=getattr(jbuilders, fn)(**kw)[0])
    g, in_name, out_name = getattr(tbuilders, fn)(**kw)
    te = Engine(EngineConfig(device="cpu", quant=quant)).load_model(
        None, graph=g)
    tree = {op: {k: ((np.asarray(v.data), np.asarray(v.scale), v.axis)
                     if isinstance(v, JQ) else np.asarray(v))
                 for k, v in d.items()}
            for op, d in je.program.weights.items()}
    carried = program_weights_from_numpy(tree, device="cpu")
    assert carried.keys() == te.program.weights.keys()
    for op in carried:
        assert carried[op].keys() == te.program.weights[op].keys(), op
    with torch.inference_mode():
        got = te.program.fn(te.place_weights(carried, te.program),
                            {in_name: torch.from_numpy(x)})[out_name]
    np.testing.assert_array_equal(got.numpy(), te.run({in_name: x})[out_name])
