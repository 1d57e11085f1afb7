"""The fused C3 block in the port (simpleinfer_tpu_torch) against the JAX
package, on the CPU: `c3_block_reference` (the plain version of
csrc/c3block.cu) against the JAX oracle and against the Pallas
`c3_block` in interpret mode, the gates, `quantize_taps`, the
si.FusedC3 lowering's dispatch and yolov5l with c3_fusion end to end.

Tolerances:
- plain version vs the JAX oracle, f32: atol 1e-5 x sqrt(C + 9 hid)
  (the same sums in another order), rtol 1e-5; with s8 taps the JAX
  package's own s8 tolerance (5e-4 x sqrt(C + 9 hid), rtol 0.02): an
  activation within rounding of an int8 step may take the next step on
  one side;
- vs the Pallas kernel in interpret mode: the JAX package's own test
  tolerance (tests/test_kernels.py: 5e-5 x sqrt(C + 9 hid) fp taps,
  5e-4 with s8 taps or bands; rtol 0.02);
- s8 taps only at one band (H <= 32), where the Pallas kernel's
  per-band abs-max is the image's: with several bands it quantizes per
  band, the oracle and the port per image (ROADMAP.md §3);
- yolov5l with c3_fusion, port vs JAX, fp32: the golden tolerance
  (5e-4 x scale atol, 5e-4 rtol);
- ops/c3.c3_chain (the bf16 library chain of the card) against
  c3_block_reference and the JAX oracle in bf16: c3_block's bf16 limit,
  max 0.05 x scale and mean 5e-4 x scale (chip_smoke.C3_MAX_TOL /
  C3_MEAN_TOL): its 3x3 rounds to bf16 before the bias.
"""
import os
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import simpleinfer_tpu.kernels.c3block as jc3
from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JCfg
from simpleinfer_tpu.quant.tensor import QuantizedTensor as JQ
from simpleinfer_tpu.zoo import build_yolov5 as jbuild
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.convert import program_weights_from_numpy
from simpleinfer_tpu_torch.ir.expression import expand_expression
from simpleinfer_tpu_torch.ir.passes import run_inference_fusions
from simpleinfer_tpu_torch.kernels import c3block as tc3
from simpleinfer_tpu_torch.ops import c3 as oc3
from simpleinfer_tpu_torch.zoo import build_yolov5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


# (n, h, w, c, hid, oc, n_btl): tests/test_kernels.py's C3_CASES
C3_CASES = [
    (2, 32, 24, 16, 8, 16, 2),
    (1, 16, 16, 128, 64, 128, 3),
    (1, 20, 20, 64, 32, 48, 1),
]


def _weights(seed, c, hid, oc, t):
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.2

    return [r(c, hid), r(hid), r(c, hid), r(hid), r(hid, oc), r(hid, oc),
            r(oc), r(t, hid, hid), r(t, hid), r(t, 9, hid, hid), r(t, hid)]


def _x(seed, n, h, w, c):
    return (np.random.default_rng(seed).standard_normal((n, h, w, c))
            .astype(np.float32) * 0.2)


def _port(x, ws, s8=False, **kw):
    args = [torch.from_numpy(a) for a in ws]
    scale = None
    if s8:
        wq, wsc = tc3.quantize_taps(ws[9])
        args[9], scale = torch.from_numpy(wq), torch.from_numpy(wsc)
    return tc3.c3_block_reference(torch.from_numpy(x), *args,
                                  btl_b_scale=scale, **kw).numpy()


def _jax_args(ws, s8=False):
    args = [jnp.asarray(a) for a in ws]
    scale = None
    if s8:
        wq, wsc = jc3.quantize_taps(ws[9])
        args[9], scale = jnp.asarray(wq), jnp.asarray(wsc)
    return args, scale


@pytest.mark.parametrize("n,h,w,c,hid,oc,t", C3_CASES)
@pytest.mark.parametrize("s8", [False, True], ids=["fp", "s8"])
@pytest.mark.parametrize("activation,shortcut", [("silu", True),
                                                 (None, False)])
def test_c3_reference_matches_jax_oracle(n, h, w, c, hid, oc, t, s8,
                                         activation, shortcut):
    ws = _weights(n + h + c, c, hid, oc, t)
    x = _x(h * w, n, h, w, c)
    args, scale = _jax_args(ws, s8)
    want = np.asarray(jc3.c3_block_reference(
        jnp.asarray(x), *args, btl_b_scale=scale, activation=activation,
        shortcut=shortcut))
    got = _port(x, ws, s8, activation=activation, shortcut=shortcut)
    np.testing.assert_allclose(got, want, rtol=0.02 if s8 else 1e-5,
                               atol=(5e-4 if s8 else 1e-5)
                               * np.sqrt(c + 9 * hid))


@pytest.mark.parametrize("n,h,w,c,hid,oc,t", C3_CASES)
def test_c3_reference_matches_pallas_interpret(n, h, w, c, hid, oc, t):
    ws = _weights(7 + h, c, hid, oc, t)
    x = _x(3 + w, n, h, w, c)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jc3.c3_block(jnp.asarray(x),
                                       *map(jnp.asarray, ws)))
    np.testing.assert_allclose(_port(x, ws), want, rtol=0.02,
                               atol=5e-5 * np.sqrt(c + 9 * hid))


@pytest.mark.parametrize("n,h,w,c,hid,oc,t,br,sc", [
    (2, 32, 24, 16, 8, 16, 2, 8, True),     # 4 bands
    (1, 40, 20, 16, 8, 16, 3, 16, False)])  # rh=10, 4 bands
def test_c3_reference_matches_pallas_banded(n, h, w, c, hid, oc, t, br, sc):
    """The Pallas kernel's multi-band grid (clamped halo bands) against
    the port's whole-image plain version, fp taps, both shortcut forms."""
    ws = _weights(11 + h, c, hid, oc, t)
    x = _x(5 + h, n, h, w, c)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jc3.c3_block(jnp.asarray(x),
                                       *map(jnp.asarray, ws),
                                       shortcut=sc, band_rows=br))
    np.testing.assert_allclose(_port(x, ws, shortcut=sc), want, rtol=0.02,
                               atol=5e-4 * np.sqrt(c + 9 * hid))


def test_c3_reference_s8_taps_match_pallas_one_band():
    """s8 taps at one band (H = 16 <= band_rows 32): the Pallas kernel's
    per-band abs-max is then the image's, the port's semantics."""
    n, h, w, c, hid, oc, t = 2, 16, 16, 128, 64, 128, 2
    ws = _weights(13, c, hid, oc, t)
    x = _x(17, n, h, w, c)
    args, scale = _jax_args(ws, s8=True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jc3.c3_block(jnp.asarray(x), *args,
                                       btl_b_scale=scale))
    np.testing.assert_allclose(_port(x, ws, s8=True), want, rtol=0.02,
                               atol=5e-4 * np.sqrt(c + 9 * hid))


def test_quantize_taps_and_gates_match_jax(monkeypatch):
    """The port's gates are the JAX package's, but for the work threshold
    of c3_profitable, measured on the H100 (C3_MIN_WORK): with the JAX
    package's threshold set, they agree everywhere."""
    monkeypatch.setattr(tc3, "C3_MIN_WORK", tc3.JAX_C3_MIN_WORK)
    ws = _weights(19, 16, 24, 16, 3)[9]
    for a, b in zip(tc3.quantize_taps(ws), jc3.quantize_taps(ws)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for h, w, c, hid, oc in [(160, 160, 128, 64, 128), (80, 80, 256, 128, 256),
                             (160, 160, 64, 32, 64), (320, 320, 128, 64, 128),
                             (40, 40, 512, 256, 512), (20, 20, 1024, 512, 1024),
                             (16, 16, 24, 72, 40)]:
        assert tc3.c3_supported(h, w, c, hid, oc) == \
            jc3.c3_supported(h, w, c, hid, oc)
        for t in (1, 3, 6, 9):
            assert tc3.c3_profitable(h, w, hid, t) == \
                jc3.c3_profitable(h, w, hid, t)
        assert tc3.c3_taps_s8_profitable(hid) == \
            jc3.c3_taps_s8_profitable(hid)


def test_c3_block_on_cpu_is_the_plain_version():
    ws = _weights(23, 16, 8, 16, 2)
    x = _x(29, 1, 9, 7, 16)
    before = tc3.launches
    args = [torch.from_numpy(a) for a in ws]
    got = tc3.c3_block(torch.from_numpy(x), *args, shortcut=False)
    want = tc3.c3_block_reference(torch.from_numpy(x), *args,
                                  shortcut=False)
    assert torch.equal(got, want) and tc3.launches == before


@pytest.mark.parametrize("n,h,w,c,hid,oc,t", C3_CASES)
@pytest.mark.parametrize("s8", [False, True], ids=["fp", "s8"])
@pytest.mark.parametrize("activation,shortcut", [("silu", True),
                                                 (None, False)])
def test_c3_chain_within_c3_limit(n, h, w, c, hid, oc, t, s8, activation,
                                  shortcut):
    """c3_chain in bf16 on the CPU (the same bf16 operands, f32 sums and
    one rounding per conv as the card's library GEMMs; s8 taps an exact
    product) against c3_block_reference and, with fp taps, the JAX
    oracle on the same inputs (with s8 taps the port's reference and the
    JAX oracle differ by an int8 step here and there:
    test_c3_reference_matches_jax_oracle holds them to the JAX package's
    s8 tolerance)."""
    ws = _weights(n + h + c + 1, c, hid, oc, t)
    x = _x(h * w + 1, n, h, w, c)
    args = [torch.from_numpy(a) for a in ws]
    scale = None
    if s8:
        wq, wsc = tc3.quantize_taps(ws[9])
        args[9], scale = torch.from_numpy(wq), torch.from_numpy(wsc)
    xt = torch.from_numpy(x).bfloat16()
    kw = dict(btl_b_scale=scale, activation=activation, shortcut=shortcut)
    got = oc3.c3_chain(xt, *args, **kw)
    assert got.dtype == torch.bfloat16
    ref = tc3.c3_block_reference(xt, *args, **kw)
    wants = [ref.float().numpy()]
    if not s8:
        jargs, _ = _jax_args(ws)
        wants.append(np.asarray(jc3.c3_block_reference(
            jnp.asarray(x).astype(jnp.bfloat16), *jargs,
            activation=activation, shortcut=shortcut).astype(jnp.float32)))
    for want in wants:
        d = np.abs(got.float().numpy() - want)
        scl = max(1.0, float(np.abs(want).max()))
        assert d.max() <= 0.05 * scl and d.mean() <= 5e-4 * scl, \
            (d.max() / scl, d.mean() / scl)


def test_fused_c3_dispatch_takes_the_chain_on_the_card_only(monkeypatch):
    """Below the gate (or with kernels off) ops/c3.py runs c3_chain for
    bf16 on the card; on the CPU it stays c3_block_reference."""
    called = []
    monkeypatch.setattr(oc3, "c3_chain",
                        lambda *a, **kw: called.append(1))
    g, in_name, out_name = build_yolov5("l", batch=1, image_size=64)
    eng = Engine(EngineConfig(device="cpu", compute_dtype="bfloat16",
                              c3_fusion=True, use_kernels=False))
    eng.load_model(None, graph=g)
    out = eng.run({in_name: _x(37, 1, 64, 64, 3)})[out_name]
    assert np.isfinite(out).all() and not called


def test_fused_c3_dispatch_follows_the_jax_gates(monkeypatch):
    """yolov5l with kernels on (on the CPU: the wrapper's plain version),
    recorded by the inputs the ops give the wrapper: the four blocks
    that pass c3_profitable at 640 reach c3_block, C3_1 (hid 64) with s8
    taps in int8 mode; the other four run the reference chain. The
    forward runs on a 64x64 image with the threshold scaled by
    (64 / 640)^2 (C3_MIN_WORK = 20000, the JAX package's threshold, for
    both gates), which keeps the same blocks."""
    calls = []
    orig = tc3.c3_block

    def spy(x, *args, btl_b_scale=None, **kw):
        calls.append((tuple(x.shape), btl_b_scale is not None))
        return orig(x, *args, btl_b_scale=btl_b_scale, **kw)

    monkeypatch.setattr(tc3, "c3_block", spy)
    monkeypatch.setattr(tc3, "C3_MIN_WORK", 20000)
    monkeypatch.setattr(tc3, "JAX_C3_MIN_WORK", 20000)
    g, in_name, out_name = build_yolov5("l", batch=1, image_size=64)
    eng = Engine(EngineConfig(device="cpu", quant="int8", c3_fusion=True,
                              use_kernels=True))
    eng.load_model(None, graph=g)
    assert [i.type for i in eng.program.impls].count("si.FusedC3") == 8
    out = eng.run({in_name: _x(31, 1, 64, 64, 3)})[out_name]
    assert np.isfinite(out).all()
    assert sorted(calls) == sorted([((1, 16, 16, 128), True),
                                    ((1, 8, 8, 256), False),
                                    ((1, 4, 4, 512), False),
                                    ((1, 8, 8, 512), False)])


@pytest.mark.parametrize("quant", [None, "int8"])
def test_yolov5l_c3_fusion_matches_jax(quant):
    """yolov5l-64 with c3_fusion, fp32, the port (kernels off: the
    reference chain, as the JAX package on the CPU) against the JAX
    Engine; int8 without calibration runs the weight-only path. Then
    (int8) the JAX program after its own calibrate, carried over with
    its scales and s8 taps, gives the port's own output on those
    scales."""
    x = _x(37, 1, 64, 64, 3) / 0.2 / 4
    jg, in_name, out_name = jbuild("l", batch=1, image_size=64)
    je = JEngine(JCfg(c3_fusion=True, quant=quant)).load_model(None,
                                                               graph=jg)
    tg = build_yolov5("l", batch=1, image_size=64)[0]
    te = Engine(EngineConfig(c3_fusion=True, quant=quant, device="cpu"))
    te.load_model(None, graph=tg)
    assert [i.type for i in te.program.impls].count("si.FusedC3") == 8
    for name, w in te.program.weights.items():
        if name.startswith("c3_"):
            jw = je.program.weights[name]
            assert w.keys() == jw.keys()
            for k in w:
                assert w[k].numpy().tobytes() == \
                    np.asarray(jw[k]).tobytes(), (name, k)
    want = np.asarray(je.run({in_name: x})[out_name])
    got = te.run({in_name: x})[out_name]
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)
    if quant != "int8":
        return
    je.calibrate([{in_name: x}])
    te._install_act_scales({k: np.asarray(w["act_scale"])
                            for k, w in je.program.weights.items()
                            if "act_scale" in w})
    carried = program_weights_from_numpy(
        {op: {k: ((np.asarray(v.data), np.asarray(v.scale), v.axis)
                  if isinstance(v, JQ) else np.asarray(v))
              for k, v in d.items()} for op, d in je.program.weights.items()},
        device="cpu")
    assert {k for d in carried.values() for k in d} >= {
        "act_scale", "btl_b_wq", "btl_b_wsc"}
    with torch.inference_mode():
        again = te.program.fn(te.place_weights(carried, te.program),
                              {in_name: torch.from_numpy(x)})[out_name]
    np.testing.assert_array_equal(again.numpy(),
                                  te.run({in_name: x})[out_name])


def test_h100_gate_dispatches_the_blocks_chip_smoke_expects(monkeypatch):
    """The H100's C3_MIN_WORK (and the JAX package's threshold, which
    decides the s8 taps), both scaled by (64 / 640)^2 for yolov5l on a
    64x64 image, static int8 with kernels on: chip_smoke.INT8_C3_BLOCKS
    blocks reach c3_block (all but the two 20x20-at-640 ones), C3_1
    alone with s8 taps, and the other INT8_C3_PLAIN_BLOCKS run the
    chain."""
    cs = _chip_smoke()
    assert tc3.C3_MIN_WORK == 1_000_000
    calls = []
    orig = tc3.c3_block

    def spy(x, *args, btl_b_scale=None, **kw):
        calls.append((tuple(x.shape), btl_b_scale is not None))
        return orig(x, *args, btl_b_scale=btl_b_scale, **kw)

    monkeypatch.setattr(tc3, "c3_block", spy)
    monkeypatch.setattr(tc3, "C3_MIN_WORK", tc3.C3_MIN_WORK // 100)
    monkeypatch.setattr(tc3, "JAX_C3_MIN_WORK", tc3.JAX_C3_MIN_WORK // 100)
    g, in_name, out_name = build_yolov5("l", batch=1, image_size=64)
    eng = Engine(EngineConfig(device="cpu", quant="int8", c3_fusion=True,
                              use_kernels=True))
    eng.load_model(None, graph=g)
    fused = [i.type for i in eng.program.impls].count("si.FusedC3")
    out = eng.run({in_name: _x(31, 1, 64, 64, 3)})[out_name]
    assert np.isfinite(out).all()
    assert len(calls) == cs.INT8_C3_BLOCKS
    assert fused - len(calls) == cs.INT8_C3_PLAIN_BLOCKS
    assert sum(s8 for _, s8 in calls) == cs.INT8_C3_S8_BLOCKS
    assert sorted(calls) == sorted([((1, 16, 16, 128), True),
                                    ((1, 8, 8, 256), False),
                                    ((1, 4, 4, 512), False),
                                    ((1, 8, 8, 512), False),
                                    ((1, 4, 4, 1024), False),
                                    ((1, 4, 4, 512), False)])


@pytest.mark.parametrize("variant,fused,s8_blocks", [("l", 8, 1),
                                                     ("s", 7, 0)])
def test_s8_taps_where_the_jax_package_gives_them(variant, fused, s8_blocks,
                                                  monkeypatch):
    """At every fused C3 block of yolov5l / YOLOv5s at 640 a static-int8
    engine takes int8 3x3 taps exactly where the JAX package's TPU
    dispatch does (c3_supported, c3_profitable at its own threshold and
    c3_taps_s8_profitable), whichever route the H100's gate sends the
    block to."""
    monkeypatch.delenv("SI_C3_MIN_WORK", raising=False)
    cs = _chip_smoke()
    graph = build_yolov5(variant, batch=1, image_size=640)[0]
    expand_expression(graph)
    run_inference_fusions(graph, EngineConfig(device="cpu", c3_fusion=True))
    hw = cs.spatial_sizes(graph)
    blocks = [op for op in graph.ops if op.type == "si.FusedC3"]
    assert len(blocks) == fused
    kernel, s8 = [], []
    for op in blocks:
        h, w = hw[op.inputs[0].name]
        c, hid, oc, t = (op.params[k].value for k in (
            "in_channels", "hidden_channels", "out_channels",
            "n_bottlenecks"))
        jax_s8 = (jc3.c3_supported(h, w, c, hid, oc)
                  and jc3.c3_profitable(h, w, hid, t)
                  and jc3.c3_taps_s8_profitable(hid))
        k_ok, port_s8 = oc3.c3_routes(h, w, c, hid, oc, t, True, True)
        assert port_s8 == jax_s8, (op.name, h, w, c, hid, oc, t)
        assert oc3.c3_routes(h, w, c, hid, oc, t, False, True)[1] is False
        kernel.append(k_ok)
        s8.append(port_s8)
    assert sum(s8) == s8_blocks
    if variant == "l":
        assert sum(kernel) == cs.INT8_C3_BLOCKS
