"""The port's detection pipeline (simpleinfer_tpu_torch/zoo/detect.py) and
native host library (simpleinfer_tpu_torch/host.py) against the JAX
package's, on the CPU.

Same inputs, made with numpy from a seed, through both packages:
- letterbox: bytes equal, route by route (native against native, numpy
  against numpy);
- nms, topk_candidates, nms_device (for nms_jax), decode_predictions and
  decode_device: indices, classes and scores equal, boxes within
  1e-6 x max(1, |box|) (BOX_RTOL);
- detect_images on port and JAX engines of the same graph and weights
  (fp32): the same detections, boxes within 1e-3 x max(1, |box|) and
  scores within 1e-5 (the two engines' heads differ by ~1e-5 x scale).
Every comparison keeps at least a stated number of rows.
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
from simpleinfer_tpu import host as jhost
from simpleinfer_tpu.zoo import detect as J
from simpleinfer_tpu.zoo.builders import build_yolov5 as jbuild_v5
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch import host as thost
from simpleinfer_tpu_torch.zoo import build_yolov5
from simpleinfer_tpu_torch.zoo import detect as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
sys.path.remove(ROOT)
BOX_RTOL = 1e-6
SIZES = [(48, 80), (80, 48), (64, 64), (37, 53), (120, 90)]


def _imgs(seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in sizes]


def planted_head(n=2, m=3000, nc=20, seed=1, head="v5", clusters=40,
                 per=12):
    """chip_smoke's planted head: background rows under 0.25 and
    clusters of partly overlapping boxes (suppression chains) with exact
    score ties inside and across clusters and tied class maxima."""
    return chip_smoke.planted_head(n, m, nc, clusters, per, seed, head)


def assert_rows_equal(got, want, floor):
    """[..., 6] decoded rows: scores and classes equal, boxes within
    BOX_RTOL x max(1, |box|); at least `floor` kept rows."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert int((want[..., 4] >= 0).sum()) >= floor
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])
    lim = BOX_RTOL * np.maximum(1.0, np.abs(want[..., :4]))
    assert (np.abs(got[..., :4] - want[..., :4]) <= lim).all()


def assert_dets_equal(got, want, floor, box_rtol=BOX_RTOL, score_tol=0.0):
    assert sum(len(d) for d in want) >= floor
    assert len(got) == len(want)
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            assert g.class_id == w.class_id
            assert abs(g.score - w.score) <= score_tol
            b = np.asarray(w.box)
            assert (np.abs(np.asarray(g.box) - b)
                    <= box_rtol * np.maximum(1.0, np.abs(b))).all()


# ---- letterbox -----------------------------------------------------------
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_letterbox_bytes_equal_jax(native, normalize):
    for img in _imgs():
        got, lb = T.letterbox(img, 64, normalize=normalize,
                              use_native=native)
        want, jlb = J.letterbox(img, 64, normalize=normalize,
                                use_native=native)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        assert (lb.scale, lb.pad_x, lb.pad_y) == (jlb.scale, jlb.pad_x,
                                                  jlb.pad_y)


@pytest.mark.parametrize("normalize", [True, False])
def test_letterbox_batch_bytes_equal_jax(normalize):
    imgs = _imgs(1)
    got = thost.letterbox_batch(imgs, 64, normalize=normalize)
    want = jhost.letterbox_batch(imgs, 64, normalize=normalize)
    assert got is not None and want is not None
    assert got.shape == (len(imgs), 64, 64, 3)
    assert got.tobytes() == want.tobytes()
    for i, im in enumerate(imgs):
        assert got[i].tobytes() == thost.letterbox_one(
            im, 64, normalize=normalize).tobytes()


@pytest.mark.parametrize("stage_uint8", [False, True],
                         ids=["float", "uint8"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_letterbox_images_bytes_equal_jax_per_image(monkeypatch, native,
                                                    stage_uint8):
    """detect_images' host side: one letterbox_batch call where the
    library is built, `letterbox` per image where it is not; either way
    the bytes and Letterbox geometry of the JAX package's detect_images
    (letterbox per image, then the uint8 rounding)."""
    imgs = _imgs(4)
    calls = []
    orig = thost.letterbox_batch
    if native:
        monkeypatch.setattr(thost, "letterbox_batch",
                            lambda *a, **kw: calls.append(1) or orig(*a,
                                                                     **kw))
    else:
        monkeypatch.setattr(thost, "letterbox_batch", lambda *a, **kw: None)
        monkeypatch.setattr(thost, "letterbox_one", lambda *a, **kw: None)
    got, lbs = T.letterbox_images(imgs, 64, stage_uint8=stage_uint8)
    canvases, jlbs = zip(*(J.letterbox(im, 64, normalize=not stage_uint8,
                                       use_native=native) for im in imgs))
    want = np.stack(canvases)
    if stage_uint8:
        want = np.clip(np.rint(want), 0, 255).astype(np.uint8)
    assert calls == ([1] if native else [])
    assert got.dtype == want.dtype and got.shape == (len(imgs), 64, 64, 3)
    assert got.tobytes() == want.tobytes()
    assert [(lb.scale, lb.pad_x, lb.pad_y) for lb in lbs] == \
        [(lb.scale, lb.pad_x, lb.pad_y) for lb in jlbs]


def test_letterbox_geometry_and_channel_order():
    img = np.full((100, 200, 3), 255, np.uint8)
    canvas, lb = T.letterbox(img, size=64, normalize=False)
    assert lb.scale == pytest.approx(64 / 200)
    assert lb.pad_y == 16 and lb.pad_x == 0
    assert (canvas[:16] == 114.0).all() and (canvas[16:48] == 255.0).all()
    img = np.zeros((10, 10, 3), np.uint8)
    img[..., 0] = 200       # blue (BGR)
    canvas, _ = T.letterbox(img, size=10, normalize=False)
    assert (canvas[..., 2] == 200).all() and (canvas[..., 0] == 0).all()
    lb = T.Letterbox(scale=0.5, pad_x=10, pad_y=20)
    np.testing.assert_allclose(lb.unmap(np.asarray(
        [[10.0, 20.0, 110.0, 120.0]])), [[0.0, 0.0, 200.0, 200.0]])


# ---- the native host library ---------------------------------------------
def test_host_library_is_the_ports_own_build():
    """Built by g++ from simpleinfer_tpu_torch/csrc/si_host.cpp into
    simpleinfer_tpu_torch/_build/, never the JAX package's
    csrc/libsi_host.so."""
    assert thost.available()
    path = thost.library()
    assert path == str(thost.library_path())
    assert os.path.dirname(path) == os.path.join(
        ROOT, "simpleinfer_tpu_torch", "_build")
    assert str(thost.SOURCE) == os.path.join(
        ROOT, "simpleinfer_tpu_torch", "csrc", "si_host.cpp")
    assert os.path.basename(path).startswith("libsi_host_")
    assert path != os.path.join(ROOT, "csrc", "libsi_host.so")


def test_library_name_carries_the_cpu(monkeypatch):
    """The library's name hashes what -march=native resolves to: a
    library built for another CPU has another name and is never loaded,
    and without g++ to say which CPU this is none is loaded at all."""
    here = thost.library_path()
    assert thost._target() and b"-march=" in thost._target()
    monkeypatch.setattr(thost, "_target", lambda: b"-march=another")
    assert thost.library_path() not in (here, None)
    assert thost.library_path().parent == here.parent
    monkeypatch.setattr(thost, "_target", lambda: None)
    monkeypatch.setattr(thost, "_lib", None)
    monkeypatch.setattr(thost, "_tried", False)
    assert thost.library_path() is None and not thost.available()


@pytest.mark.parametrize("entries", [3, 40])
def test_storezip_reader_native_index_equals_python_walk(tmp_path,
                                                         monkeypatch,
                                                         entries):
    """The port's StoreZipReader indexes an archive of 1 MiB or more with
    host.storezip_index (as the JAX package's does): the same index and
    bytes as its Python walk and as the JAX package's reader."""
    from simpleinfer_tpu.ir.storezip import StoreZipReader as JReader
    from simpleinfer_tpu_torch.ir import storezip as tz

    rng = np.random.default_rng(entries)
    blobs = {f"op{i}.weight": rng.integers(
        0, 256, (2 << 20) // entries + i, dtype=np.uint8).tobytes()
        for i in range(entries)}
    path = str(tmp_path / "w.bin")
    with tz.StoreZipWriter(path) as w:
        for name, data in blobs.items():
            w.write_file(name, data)
    calls = []
    orig = thost.storezip_index
    monkeypatch.setattr(thost, "storezip_index",
                        lambda buf: calls.append(1) or orig(buf))
    with tz.StoreZipReader(path) as r:
        native = {n: (r._index[n].offset, r._index[n].size)
                  for n in r.namelist()}
        assert all(r.read_file(n) == d for n, d in blobs.items())
    assert calls == [1]
    monkeypatch.setattr(tz.StoreZipReader, "_NATIVE_THRESHOLD", 1 << 40)
    with tz.StoreZipReader(path) as r:
        walked = {n: (r._index[n].offset, r._index[n].size)
                  for n in r.namelist()}
    with JReader(path) as r:
        jax_index = {n: (r._index[n].offset, r._index[n].size)
                     for n in r.namelist()}
    assert calls == [1] and native == walked == jax_index
    assert len(native) == entries


def test_storezip_index_matches_jax(tmp_path):
    from simpleinfer_tpu_torch.ir.storezip import StoreZipWriter

    path = str(tmp_path / "w.bin")
    with StoreZipWriter(path) as w:
        for i in range(20):
            w.write_file(f"op{i}.weight", bytes(range(i, i + 37)))
    buf = open(path, "rb").read()
    idx = thost.storezip_index(buf)
    assert idx == jhost.storezip_index(buf) and len(idx) == 20
    off, size = idx["op3.weight"]
    assert buf[off:off + size] == bytes(range(3, 40))


def test_storezip_index_overflow_returns_none(tmp_path):
    from simpleinfer_tpu_torch.ir.storezip import StoreZipWriter

    path = str(tmp_path / "big.bin")
    with StoreZipWriter(path) as w:
        for i in range(4100):
            w.write_file(f"f{i:04d}", b"x")
    assert thost.storezip_index(open(path, "rb").read()) is None


def _random_boxes(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    wh = rng.uniform(4, 120, (n, 2)).astype(np.float32)
    return (np.concatenate([xy, xy + wh], 1),
            rng.uniform(0, 1, n).astype(np.float32))


@pytest.mark.parametrize("case", ["n0", "n1", "n7", "n500", "n3000",
                                  "ties", "nan", "f64", "max_keep"])
def test_nms_matches_jax(case):
    """The port's nms (native for f32, numpy for f64 or NaN scores) gives
    the JAX package's indices."""
    n = int(case[1:]) if case.startswith("n") and case != "nan" else 64
    boxes, scores = _random_boxes(n, seed=n + 1)
    max_keep = 300
    if case == "ties":
        scores = np.full(n, 0.5, np.float32)
    elif case == "nan":
        scores[3] = np.nan
    elif case == "f64":
        boxes, scores = boxes.astype(np.float64), scores.astype(np.float64)
    elif case == "max_keep":
        boxes = np.asarray([[i * 200.0, 0, i * 200 + 10, 10]
                            for i in range(10)], np.float32)
        scores, max_keep = np.linspace(0.9, 0.1, 10).astype(np.float32), 4
    got = T.nms(boxes, scores, 0.45, max_keep)
    want = J.nms(boxes, scores, 0.45, max_keep)
    np.testing.assert_array_equal(got, want)
    assert len(want) >= min(n, 1)
    if case == "max_keep":
        assert list(got) == [0, 1, 2, 3]
    if case not in ("nan", "f64"):
        np.testing.assert_array_equal(
            got, T.nms(boxes.astype(np.float64), scores.astype(np.float64),
                       0.45, max_keep))


def test_iou_xyxy_matches_jax():
    a = np.asarray([0.0, 0, 10, 10])
    b = np.asarray([[5.0, 5, 15, 15], [20, 20, 30, 30], [0, 0, 10, 10]])
    np.testing.assert_array_equal(T.iou_xyxy(a, b), J.iou_xyxy(a, b))
    np.testing.assert_allclose(T.iou_xyxy(a, b), [25 / 175, 0.0, 1.0],
                               atol=1e-6)


# ---- decode_predictions (host) ------------------------------------------
def _row(cx, cy, w, h, obj, cls):
    return np.asarray([cx, cy, w, h, obj, *cls], np.float32)


@pytest.mark.parametrize("head", ["v5", "v8"])
@pytest.mark.parametrize("class_agnostic", [False, True],
                         ids=["classwise", "agnostic"])
@pytest.mark.parametrize("mapped", [False, True], ids=["raw", "unmap_clip"])
def test_decode_predictions_matches_jax(head, class_agnostic, mapped):
    pred = planted_head(head=head)
    lb = T.Letterbox(scale=0.8, pad_x=12, pad_y=40) if mapped else None
    jlb = J.Letterbox(scale=0.8, pad_x=12, pad_y=40) if mapped else None
    shape = (500, 700) if mapped else None
    for i in range(pred.shape[0]):
        got = T.decode_predictions(pred[i], lb, image_shape=shape,
                                   class_agnostic=class_agnostic, head=head)
        want = J.decode_predictions(pred[i], jlb, image_shape=shape,
                                    class_agnostic=class_agnostic,
                                    head=head)
        assert [(d.box, d.score, d.class_id) for d in got] == \
            [(d.box, d.score, d.class_id) for d in want]
        assert len(want) >= 30


def test_decode_predictions_hand_cases():
    pred = np.stack([_row(100, 100, 20, 20, 0.9, [0.9, 0.05, 0.05]),
                     _row(100, 100, 22, 22, 0.8, [0.0, 0.9, 0.1]),
                     _row(300, 300, 40, 40, 0.9, [0.0, 0.1, 0.9]),
                     _row(50, 50, 10, 10, 0.1, [0.9, 0.05, 0.05])])
    dets = T.decode_predictions(pred)
    assert sorted(d.class_id for d in dets) == [0, 1, 2]
    d0 = next(d for d in dets if d.class_id == 0)
    assert d0.box == pytest.approx((90, 90, 110, 110))
    assert d0.score == pytest.approx(0.81) and d0.class_name == "person"
    assert len(T.decode_predictions(pred[:2, :5 + 2], class_agnostic=True)
               ) == 1
    clip = T.decode_predictions(np.stack([_row(5, 5, 20, 20, 0.9, [1.0])]),
                                T.Letterbox(1.0, 0, 0),
                                image_shape=(100, 100))
    assert clip[0].box == pytest.approx((0, 0, 15, 15))
    assert T.decode_predictions(np.zeros((10, 85), np.float32)) == [] \
        == J.decode_predictions(np.zeros((10, 85), np.float32))


# ---- the device side ---------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_candidates_matches_jax(dtype):
    pred = planted_head(seed=3)
    pred[:, 5:15] = pred[:, :10]            # tied scores across rows
    got = T.topk_candidates(torch.from_numpy(pred).to(getattr(torch, dtype)),
                            k=300)
    want = J.topk_candidates(jnp.asarray(pred, getattr(jnp, dtype)), k=300)
    assert got.shape == (2, 300, pred.shape[-1])
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _nms_boxes(case, seed=11, n=64):
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0, 80, (n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 30, (n, 2))
    scores = rng.permutation(n).astype(np.float32) / n
    if case == "ties":
        scores = np.round(scores * 4) / 4      # 5 levels, many ties
    elif case == "all_suppressed":
        boxes[:] = boxes[0]
    elif case == "disjoint":
        boxes = np.asarray([[i * 20.0, 0, i * 20 + 10, 10]
                            for i in range(n)], np.float32)
    elif case == "absent":
        scores[::3] = -1.0
    return boxes, scores


@pytest.mark.parametrize("case", ["distinct", "ties", "all_suppressed",
                                  "disjoint", "absent"])
@pytest.mark.parametrize("thr", [0.3, 0.45, 0.7])
@pytest.mark.parametrize("max_keep", [3, 64, 100])
def test_nms_device_matches_nms_jax(case, thr, max_keep):
    boxes, scores = _nms_boxes(case)
    got = T.nms_device(torch.from_numpy(boxes), torch.from_numpy(scores),
                       thr, max_keep).numpy()
    want = np.asarray(J.nms_jax(boxes, scores, thr, max_keep))
    assert got.dtype == np.int32 and got.shape == (max_keep,)
    np.testing.assert_array_equal(got, want)
    assert int((want >= 0).sum()) >= 1
    if case == "all_suppressed":
        assert list(want[:2]) == [int(np.argmax(scores)), -1]
    if case == "disjoint":
        assert int((want >= 0).sum()) == min(max_keep, 64)


def test_nms_device_batched_equals_per_image():
    b = [_nms_boxes(c, seed=s) for c, s in (("distinct", 1), ("ties", 2),
                                            ("absent", 3))]
    boxes = torch.from_numpy(np.stack([x for x, _ in b]))
    scores = torch.from_numpy(np.stack([s for _, s in b]))
    got = T.nms_device(boxes, scores, 0.45, 40)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(J.nms_jax(b[i][0], b[i][1], 0.45,
                                                 40)))


@pytest.mark.parametrize("head", ["v5", "v8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("class_agnostic", [False, True],
                         ids=["classwise", "agnostic"])
def test_decode_device_matches_jax(head, dtype, class_agnostic):
    """Planted clusters with exact ties: the port's decode_device gives
    JAX's rows, f32 and bf16 heads, and on the same values the host
    decode's detections."""
    pred = planted_head(head=head, m=4000, nc=80, clusters=60)
    got = T.decode_device(torch.from_numpy(pred).to(getattr(torch, dtype)),
                          head=head, class_agnostic=class_agnostic)
    want = J.decode_device(jnp.asarray(pred, getattr(jnp, dtype)), head=head,
                           class_agnostic=class_agnostic)
    assert got.dtype == torch.float32 and got.shape == (2, 300, 6)
    assert_rows_equal(got.numpy(), np.asarray(want), floor=100)
    vals = torch.from_numpy(pred).to(getattr(torch, dtype)).float().numpy()
    for i in range(2):
        rows = got[i].numpy()
        rows = rows[rows[:, 4] >= 0]
        host = T.decode_predictions(vals[i], head=head,
                                    class_agnostic=class_agnostic)
        assert len(rows) == len(host)
        for r, d in zip(rows, host):
            assert (int(r[5]), float(r[4])) == (d.class_id, d.score)
            assert np.allclose(r[:4], d.box, rtol=0, atol=1e-4)


@pytest.mark.parametrize("pre_topk", [64, 1024])
def test_decode_device_pre_topk_and_empty_match_jax(pre_topk):
    pred = planted_head(m=2000, seed=9)
    got = T.decode_device(torch.from_numpy(pred), max_det=50,
                          pre_topk=pre_topk)
    want = J.decode_device(pred, max_det=50, pre_topk=pre_topk)
    assert_rows_equal(got.numpy(), np.asarray(want), floor=20)
    empty = T.decode_device(torch.zeros(1, 20, 7), head="v8", max_det=8)
    np.testing.assert_array_equal(
        empty.numpy(), np.asarray(J.decode_device(np.zeros((1, 20, 7),
                                                           np.float32),
                                                  head="v8", max_det=8)))
    assert (empty[0, :, 4] < 0).all()


def test_nms_rounds_are_the_chain_length_not_k():
    """Disjoint boxes settle in one round whatever K; a chain of boxes
    each overlapping the next needs about its length."""
    for k in (16, 256):
        boxes = torch.tensor([[i * 20.0, 0, i * 20 + 10, 10]
                              for i in range(k)])[None]
        _, keep, rounds = T.nms_rounds(boxes, torch.linspace(1, 0.1, k)[None])
        assert rounds == 1 and bool(keep.all())
    chain = torch.tensor([[i * 2.0, 0, i * 2 + 10, 10]
                          for i in range(12)])[None]
    _, keep, rounds = T.nms_rounds(chain, torch.linspace(1, 0.1, 12)[None])
    assert rounds >= 6
    want = J.nms_jax(chain[0].numpy(), np.linspace(1, 0.1, 12,
                                                   dtype=np.float32),
                     0.45, 12)
    assert keep[0].nonzero().flatten().tolist() == \
        [int(i) for i in np.asarray(want) if i >= 0]


# ---- detect_images end to end --------------------------------------------
def _engines(head, batch=2, image=64):
    if head == "v8":
        from simpleinfer_tpu.zoo.builders import build_yolov8 as jb
        from simpleinfer_tpu_torch.zoo import build_yolov8 as tb
        variant = "n"
    else:
        jb, tb, variant = jbuild_v5, build_yolov5, "n"
    gj, _, _ = jb(variant, batch=batch, image_size=image)
    gt, _, _ = tb(variant, batch=batch, image_size=image)
    return (Engine(EngineConfig(device="cpu")).load_model(None, graph=gt),
            JEngine(JCfg()).load_model(None, graph=gj))


@pytest.mark.parametrize("head,image", [("v5", 64), ("v5", 128),
                                        ("v8", 64), ("v8", 128)])
@pytest.mark.parametrize("device_decode", [False, True],
                         ids=["host_decode", "device_decode"])
def test_detect_images_matches_jax(head, image, device_decode):
    """YOLOv5n / YOLOv8n, same graph and weights, fp32: the port's
    detect_images gives the JAX package's detections (head="auto")."""
    te, je = _engines(head, image=image)
    imgs = _imgs(2, [(48, 80), (80, 48)])
    got = T.detect_images(te, imgs, size=image, device_decode=device_decode)
    want = J.detect_images(je, imgs, size=image, device_decode=device_decode)
    assert_dets_equal(got, want, floor=20, box_rtol=1e-3, score_tol=1e-5)


def test_detect_images_routes_agree_and_uint8_staging():
    te, je = _engines("v5")
    imgs = _imgs(3, [(48, 80), (80, 48)])
    host = T.detect_images(te, imgs, size=64)
    dev = T.detect_images(te, imgs, size=64, device_decode=True)
    assert_dets_equal(dev, host, floor=100, box_rtol=1e-4, score_tol=1e-6)
    got = T.detect_images(te, imgs, size=64, stage_uint8=True,
                          device_decode=True)
    want = J.detect_images(je, imgs, size=64, stage_uint8=True,
                           device_decode=True)
    assert_dets_equal(got, want, floor=100, box_rtol=1e-3, score_tol=1e-5)
    for dets, img in zip(got, imgs):
        for d in dets:
            assert 0 <= d.box[0] <= d.box[2] <= img.shape[1]
            assert 0 <= d.box[1] <= d.box[3] <= img.shape[0]


def test_real_images_demo_chain_matches_jax(tmp_path):
    """scripts/yolo_real_images_demo.py's chain through the port: build
    yolov5s, save the pnnx pair, load it, read docs/imgs/result_*.jpg,
    detect_images(device_decode=True), draw and write: the same
    detections as the JAX package on the same weights and images."""
    from simpleinfer_tpu.zoo.imageio import imread as jimread
    from simpleinfer_tpu_torch.zoo.imageio import (draw_detections, imread,
                                                   imwrite)

    names = sorted(n for n in os.listdir(os.path.join(ROOT, "docs", "imgs"))
                   if n.startswith("result_") and n.endswith(".jpg"))
    assert len(names) == 4
    paths = [os.path.join(ROOT, "docs", "imgs", n) for n in names]
    size = 128
    g, _, _ = build_yolov5("s", batch=len(paths), image_size=size, seed=7)
    param, binp = str(tmp_path / "m.pnnx.param"), str(tmp_path / "m.pnnx.bin")
    g.save(param, binp)
    te = Engine(EngineConfig(device="cpu")).load_model(param, binp)
    je = JEngine(JCfg()).load_model(param, binp)
    images = [imread(p) for p in paths]
    for a, p in zip(images, paths):
        np.testing.assert_array_equal(a, jimread(p))
    got = T.detect_images(te, images, size=size, device_decode=True)
    want = J.detect_images(je, images, size=size, device_decode=True)
    assert_dets_equal(got, want, floor=400, box_rtol=1e-3, score_tol=1e-5)
    for img, dets in zip(images, got):
        out = str(tmp_path / "result.png")
        imwrite(out, draw_detections(img.copy(), dets[:20]))
        assert imread(out).shape == img.shape


def test_chip_smoke_detect_phases_rehearse_on_cpu():
    """chip_smoke.py's host_native, detect_v5, detect_v8, engine_warmup
    and segment phases at a tiny size on the CPU."""
    out = chip_smoke.detect_rehearsal(torch.device("cpu"))
    assert out["host_native"]["nms_native_equals_numpy"]
    assert all(r["equal"] for r in out["planted"])
    assert out["v5"]["kernel_convs_per_forward"] == 22
    assert out["v8"]["kernel_convs_per_forward"] == 11
    assert out["v5"]["decode_vs_host"]["kept_rows"] >= 100
    assert len(out["v5"]["routes"]) == 4
    assert out["warmup"]["temp_bytes"] == {1: None, 2: None}
