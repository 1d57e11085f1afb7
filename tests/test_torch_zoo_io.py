"""The port's Engine.warmup / temp_bytes / initialize_context, ir/codegen,
zoo/metrics, zoo/imageio and zoo/segment against the JAX package's, on
the CPU. Same inputs, made with numpy from a seed, through both:
metrics and drawings equal; fp32 engine outputs within the golden
tolerance (atol = rtol = 5e-4 x scale); segmentation masks equal pixel
for pixel.
"""
import logging
import os
import runpy

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JCfg
from simpleinfer_tpu.zoo import imageio as jio
from simpleinfer_tpu.zoo import metrics as jm
from simpleinfer_tpu.zoo import segment as jseg
from simpleinfer_tpu.zoo.builders import build_unet as jbuild_unet
from simpleinfer_tpu.zoo.detect import Detection as JDetection
from simpleinfer_tpu_torch import (Engine, EngineConfig, EngineStateError,
                                   initialize_context)
from simpleinfer_tpu_torch.zoo import build_resnet18, build_unet, build_yolov5
from simpleinfer_tpu_torch.zoo import imageio as tio
from simpleinfer_tpu_torch.zoo import metrics as tm
from simpleinfer_tpu_torch.zoo import segment as tseg
from simpleinfer_tpu_torch.zoo.detect import Detection

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG_SEED = 61


def _rng(k=0):
    return np.random.default_rng(RNG_SEED + k)


def golden_close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)


# ---- Engine.warmup / temp_bytes / initialize_context ----------------------
def test_warmup_runs_each_batch_and_keeps_state(monkeypatch):
    g, i, o = build_yolov5("n", batch=2, image_size=32)
    eng = Engine(EngineConfig(device="cpu", quant="int8w",
                              use_kernels=True)).load_model(None, graph=g)
    x = _rng().standard_normal((2, 32, 32, 3)).astype(np.float32)
    eng.input(i, x)
    eng.forward()
    before = eng.extract(o)
    seen = []
    orig = eng._program.fn

    def spy(weights, inputs):
        seen.append(tuple(inputs[i].shape))
        return orig(weights, inputs)

    monkeypatch.setattr(eng._program, "fn", spy)
    eng.warmup((1, 4))
    assert seen == [(1, 32, 32, 3), (4, 32, 32, 3)]
    np.testing.assert_array_equal(eng.extract(o), before)
    eng.forward()        # the staged input is still the user's
    np.testing.assert_array_equal(eng.extract(o), before)


def test_warmup_and_temp_bytes_need_declared_shapes():
    g, i, o = build_yolov5("n", batch=1, image_size=32)
    for op in g.ops:
        if op.type == "pnnx.Input":
            op.outputs[0].shape = [1, 3, -1, 32]
    eng = Engine(EngineConfig(device="cpu")).load_model(None, graph=g)
    with pytest.raises(EngineStateError, match="dynamic"):
        eng.warmup((1,))
    assert eng.temp_bytes(2) is None      # the CPU keeps no statistics
    with pytest.raises(EngineStateError):
        Engine(EngineConfig(device="cpu")).warmup()


def test_temp_bytes_is_none_on_the_cpu_as_jax_without_a_report():
    g, _, _ = build_yolov5("n", batch=1, image_size=32)
    eng = Engine(EngineConfig(device="cpu")).load_model(None, graph=g)
    assert eng.temp_bytes(1) is None and eng.temp_bytes(8) is None


def test_initialize_context_sets_up_logging(monkeypatch):
    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", [])
    initialize_context()
    assert root.handlers and root.level == logging.INFO
    n = len(root.handlers)
    initialize_context()            # idempotent
    assert len(root.handlers) == n


# ---- ir/codegen --------------------------------------------------------
def test_codegen_roundtrip_matches_jax(tmp_path):
    from simpleinfer_tpu.ir.codegen import graph_to_python as jgen
    from simpleinfer_tpu.zoo.builders import build_resnet18 as jbuild
    from simpleinfer_tpu_torch.ir.codegen import (export_python,
                                                  graph_to_python)

    graph, i, o = build_resnet18(batch=1, image_size=32, num_classes=5,
                                 width=8)
    py, npz = str(tmp_path / "gen.py"), str(tmp_path / "w.npz")
    export_python(graph, py, npz)
    src = open(py).read()
    assert "from simpleinfer_tpu_torch.ir.graph import" in src
    assert "simpleinfer_tpu.ir" not in src
    jsrc = jgen(jbuild(batch=1, image_size=32, num_classes=5, width=8)[0],
                npz)
    assert src == jsrc.replace("simpleinfer_tpu.", "simpleinfer_tpu_torch.")
    rebuilt = runpy.run_path(py)["build_graph"]()
    assert len(rebuilt.ops) == len(graph.ops)
    x = _rng(1).standard_normal((1, 32, 32, 3)).astype(np.float32)
    a = Engine(EngineConfig(device="cpu")).load_model(
        None, graph=graph).run({i: x})[o]
    b = Engine(EngineConfig(device="cpu")).load_model(
        None, graph=rebuilt).run({i: x})[o]
    np.testing.assert_array_equal(a, b)
    assert graph_to_python(rebuilt, npz).count("new_operator") == len(
        graph.ops)


# ---- zoo/metrics -------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 100, (6, 4))
    gt[:, 2:] = gt[:, :2] + rng.uniform(5, 30, (6, 2))
    src = rng.integers(0, 6, 9)          # the box each prediction copies
    preds = gt[src] + rng.normal(0, 3, (9, 4))
    scores = rng.uniform(0, 1, 9)
    tp = tm.match_detections(preds, scores, gt)
    np.testing.assert_array_equal(tp, jm.match_detections(preds, scores,
                                                          gt))
    assert tm.average_precision(tp, scores, 6) == jm.average_precision(
        tp, scores, 6)
    P = [[(preds[k], scores[k], src[k] % 3) for k in range(9)
          if src[k] % 2 == j] for j in range(2)]
    G = [[(gt[k], k % 3) for k in range(j, 6, 2)] for j in range(2)]
    for th in ((0.5,), (0.5, 0.75)):
        a = tm.mean_average_precision(P, G, 3, th)
        assert a == jm.mean_average_precision(P, G, 3, th) and a > 0
    logits = rng.standard_normal((20, 7))
    labels = rng.integers(0, 7, 20)
    assert tm.top1_accuracy(logits, labels) == jm.top1_accuracy(logits,
                                                                labels)
    for k in (1, 3, 7):
        assert tm.topk_accuracy(logits, labels, k) == jm.topk_accuracy(
            logits, labels, k)


def test_metrics_hand_cases():
    gt = np.asarray([[0.0, 0, 10, 10], [20, 20, 30, 30]])
    preds = [[0.0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
             [50, 50, 60, 60]]
    assert tm.match_detections(preds, [0.9, 0.8, 0.7, 0.6], gt).tolist() \
        == [True, False, True, False]
    ap = tm.average_precision(np.asarray([1, 0, 1]),
                              np.asarray([0.9, 0.8, 0.7]), n_gt=2)
    assert ap == pytest.approx(0.5 + 0.5 * 2 / 3)
    assert np.isnan(tm.mean_average_precision([[]], [[]], 2))


def test_int8_parity_report_on_port_engines_matches_jax():
    """int8_parity_report over port engines (fp32 vs int8w) gives the
    JAX package's report on JAX engines of the same graph, within the
    engines' own distance."""
    from simpleinfer_tpu.zoo.builders import build_yolov5 as jbuild

    x = _rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32) / 2
    reps = []
    for E, C, B, kw in ((Engine, EngineConfig, build_yolov5,
                         dict(device="cpu")), (JEngine, JCfg, jbuild, {})):
        fp = E(C(**kw)).load_model(None, graph=B("n", batch=2,
                                                 image_size=64)[0])
        q = E(C(quant="int8w", **kw)).load_model(
            None, graph=B("n", batch=2, image_size=64)[0])
        reps.append((tm if E is Engine else jm).int8_parity_report(
            fp, q, x, conf_thresh=0.25))
    port, jx = reps
    assert port.n_images == jx.n_images == 2
    assert port.fp32_detections == jx.fp32_detections >= 100
    assert abs(port.quant_detections - jx.quant_detections) <= 2
    assert port.box_recall >= 0.9 and jx.box_recall >= 0.9
    assert port.map_vs_fp32 == pytest.approx(jx.map_vs_fp32, abs=0.05)
    assert port.max_abs_logit_delta < 50.0
    assert "int8-vs-fp32" in str(port)


# ---- zoo/imageio -------------------------------------------------------
def test_ppm_roundtrip_and_whitespace_pixels(tmp_path):
    img = _rng(3).integers(0, 256, (37, 53, 3)).astype(np.uint8)
    img[0, 0] = (0x20, 0x0A, 0x0D)
    p = str(tmp_path / "t.ppm")
    tio.imwrite(p, img)
    np.testing.assert_array_equal(tio.imread(p), img)
    np.testing.assert_array_equal(jio.imread(p), img)
    assert open(p, "rb").read()[:12] == b"P6\n53 37\n255"


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_pil_files_read_as_jax_reads_them(tmp_path, ext):
    """PNG / JPEG through PIL (installed here; the card's machine has no
    PIL and nothing there reads these): the port writes and reads what
    the JAX package writes and reads, BGR by default."""
    img = _rng(4).integers(0, 256, (20, 30, 3)).astype(np.uint8)
    p = str(tmp_path / f"t.{ext}")
    tio.imwrite(p, img)
    jp = str(tmp_path / f"j.{ext}")
    jio.imwrite(jp, img)
    assert open(p, "rb").read() == open(jp, "rb").read()
    np.testing.assert_array_equal(tio.imread(p), jio.imread(p))
    np.testing.assert_array_equal(tio.imread(p, bgr=False),
                                  tio.imread(p)[..., ::-1])
    if ext == "png":
        np.testing.assert_array_equal(tio.imread(p), img)


def test_docs_jpegs_read_as_jax_reads_them():
    d = os.path.join(ROOT, "docs", "imgs")
    for name in sorted(os.listdir(d)):
        if name.startswith("result_") and name.endswith(".jpg"):
            a = tio.imread(os.path.join(d, name))
            assert a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3
            np.testing.assert_array_equal(a, jio.imread(os.path.join(
                d, name)))


def test_drawing_matches_jax():
    img = _rng(5).integers(0, 256, (64, 80, 3)).astype(np.uint8)
    a, b = img.copy(), img.copy()
    tio.draw_rectangle(a, (2, 3), (70, 50), (0, 255, 0), thickness=2)
    jio.draw_rectangle(b, (2, 3), (70, 50), (0, 255, 0), thickness=2)
    tio.draw_rectangle(a, (-5, -5), (100, 100))
    jio.draw_rectangle(b, (-5, -5), (100, 100))
    tio.draw_text(a, "CAR 87%", (4, 4), (255, 0, 0), scale=2)
    jio.draw_text(b, "CAR 87%", (4, 4), (255, 0, 0), scale=2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, img)
    dets = [(5, 5, 30, 40, 0.87, 0), (40, 10, 60, 50, 0.5, 2),
            (0, 0, 200, 200, 0.3, 79)]
    out = tio.draw_detections(img, [Detection(d[:4], d[4], d[5])
                                    for d in dets])
    want = jio.draw_detections(img, [JDetection(d[:4], d[4], d[5])
                                     for d in dets])
    np.testing.assert_array_equal(out, want)
    assert not np.array_equal(out, img)


# ---- zoo/segment -------------------------------------------------------
@pytest.mark.parametrize("device_argmax", [True, False],
                         ids=["device_argmax", "host_argmax"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_images_matches_jax(device_argmax, dtype):
    """build_unet at 32 px, same graph and weights: the port's masks
    equal the JAX package's pixel for pixel, with at least 3 classes
    seen; the device and host argmax give the same masks."""
    gt, _, _ = build_unet(batch=2, image_size=32, num_classes=4, width=8,
                          depth=1)
    gj, _, _ = jbuild_unet(batch=2, image_size=32, num_classes=4, width=8,
                           depth=1)
    te = Engine(EngineConfig(device="cpu", compute_dtype=dtype)
                ).load_model(None, graph=gt)
    je = JEngine(JCfg(compute_dtype=dtype)).load_model(None, graph=gj)
    imgs = [_rng(6).integers(0, 255, (48, 64, 3)).astype(np.uint8),
            _rng(7).integers(0, 255, (32, 32, 3)).astype(np.uint8)]
    got = tseg.segment_images(te, imgs, device_argmax=device_argmax)
    other = tseg.segment_images(te, imgs, device_argmax=not device_argmax)
    want = jseg.segment_images(je, imgs, device_argmax=device_argmax)
    assert [m.shape for m in got] == [(48, 64), (32, 32)]
    assert got[0].dtype == np.int32
    for a, b, c in zip(got, want, other):
        np.testing.assert_array_equal(a, c)
        if dtype == "float32":
            np.testing.assert_array_equal(a, b)
        else:    # bf16 logits: a near-tied pixel may take the other class
            assert (a != b).mean() <= 0.02
    assert len(np.unique(got[0])) >= 3
    np.testing.assert_array_equal(tseg.colorize_mask(imgs[0], got[0]),
                                  jseg.colorize_mask(imgs[0], got[0]))
    x = tseg.preprocess_segment(imgs[0], 32)
    np.testing.assert_array_equal(x, jseg.preprocess_segment(imgs[0], 32))
    if dtype == "float32":
        batch = np.repeat(x[None], 2, 0)
        golden_close(te.run({te.input_names[0]: batch})[te.output_names[0]],
                     je.run({je.input_names[0]: batch})[je.output_names[0]])


def test_warmup_on_an_nchw_engine():
    """An io_layout='nchw' engine reads rank-4 arrays as NCHW: warmup and
    temp_bytes feed zeros in that layout (the JAX package's warmup feeds
    NHWC zeros there and fails in its conv)."""
    g, i, o = build_yolov5("n", batch=1, image_size=32)
    eng = Engine(EngineConfig(device="cpu", io_layout="nchw")).load_model(
        None, graph=g)
    eng.warmup((1, 2))
    assert eng.temp_bytes(2) is None
    out = eng.run({i: np.zeros((2, 3, 32, 32), np.float32)})[o]
    assert out.shape == (2, 63, 85)
