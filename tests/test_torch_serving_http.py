"""The port's HTTP front end (simpleinfer_tpu_torch/serving/http.py) on
the CPU: the scenarios of tests/test_serving_http.py that need no
generation service, against a port server on an ephemeral port;
/v1/generate answering 400; and the JAX package's server and the
port's on the same requests: /v1/infer (npy, resnet18-32 width 8 fp32)
and /v1/detect (build_yolov5("n", image_size=64) fp32, host decode and
device decode). Parity: the same count and class ids, boxes and scores
within the golden tolerance (atol = rtol = 5e-4 x scale,
tests/test_golden.py:102, scale = max(1, |ref|) over the reply)."""
import http.client
import io
import json
import urllib.error
import urllib.request

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu.serving import BatchingService as JBatchingService
from simpleinfer_tpu.serving import InferenceServer as JInferenceServer
from simpleinfer_tpu.zoo import build_resnet18 as jbuild_resnet18
from simpleinfer_tpu.zoo import build_yolov5 as jbuild_yolov5
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.serving import BatchingService, InferenceServer
from simpleinfer_tpu_torch.serving.http import NPY_CONTENT_TYPE
from simpleinfer_tpu_torch.zoo import build_resnet18, build_yolov5

RNG = np.random.default_rng(7)
GOLDEN_TOL = 5e-4


def _cpu_engine(graph, **cfg):
    return Engine(EngineConfig(device="cpu", **cfg)).load_model(
        None, graph=graph)


def _serve(svc):
    server = InferenceServer(svc.start(), port=0).start()
    host, port = server.address[:2]
    return server, f"http://{host}:{port}"


@pytest.fixture(scope="module")
def served():
    graph, _, _ = build_resnet18(batch=1, image_size=32, num_classes=6,
                                 width=8)
    eng = _cpu_engine(graph)
    svc = BatchingService(eng, max_batch=8, max_wait_ms=20)
    server, base = _serve(svc)
    yield eng, svc, base
    server.stop()
    svc.stop(drain=False)


def _post(url, body: bytes, ctype: str):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def test_healthz(served):
    _, _, base = served
    status, body = _get_json(base + "/healthz")
    assert status == 200 and body == {"status": "ok"}


def test_infer_npy_roundtrip(served):
    eng, _, base = served
    x = RNG.standard_normal((32, 32, 3)).astype(np.float32)
    status, ctype, body = _post(base + "/v1/infer", _npy(x),
                                NPY_CONTENT_TYPE)
    assert status == 200 and ctype == NPY_CONTENT_TYPE
    got = np.load(io.BytesIO(body), allow_pickle=False)
    want = eng.run({eng.input_names[0]: x[None]})[eng.output_names[0]][0]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_infer_json_roundtrip(served):
    eng, _, base = served
    x = RNG.standard_normal((32, 32, 3)).astype(np.float32)
    status, _, body = _post(base + "/v1/infer",
                            json.dumps({"input": x.tolist()}).encode(),
                            "application/json")
    assert status == 200
    payload = json.loads(body)
    got = np.asarray(payload["output"], dtype=np.float32)
    assert payload["shape"] == list(got.shape)
    want = eng.run({eng.input_names[0]: x[None]})[eng.output_names[0]][0]
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_concurrent_requests_batched(served):
    eng, svc, base = served
    import concurrent.futures as cf

    xs = [RNG.standard_normal((32, 32, 3)).astype(np.float32)
          for _ in range(12)]

    def one(x):
        status, _, body = _post(base + "/v1/infer", _npy(x),
                                NPY_CONTENT_TYPE)
        assert status == 200
        return np.load(io.BytesIO(body), allow_pickle=False)

    before = svc.stats.batches
    with cf.ThreadPoolExecutor(max_workers=12) as ex:
        got = np.stack(list(ex.map(one, xs)))
    want = eng.run({eng.input_names[0]: np.stack(xs)})[eng.output_names[0]]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # concurrent posts should merge into fewer device batches
    assert svc.stats.batches - before < 12


def test_stats_endpoint(served):
    _, svc, base = served
    status, body = _get_json(base + "/v1/stats?slo_ms=1000")
    assert status == 200
    assert body["requests"] == svc.stats.requests
    assert body["item_shape"] == [32, 32, 3]
    assert "slo" in body and isinstance(body["per_bucket"], dict)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get_json(base + "/v1/stats?slo_ms=abc")
    assert ei.value.code == 400


def test_metrics_prometheus_format(served):
    _, svc, base = served
    with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
        assert resp.status == 200
        assert resp.headers.get("Content-Type", "").startswith("text/plain")
        text = resp.read().decode()
    assert f"si_requests_total {svc.stats.requests}" in text
    assert "# TYPE si_batches_total counter" in text
    assert "si_batch_occupancy" in text


def test_bad_shape_is_400(served):
    _, _, base = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/infer", _npy(np.zeros((8, 8, 3), np.float32)),
              NPY_CONTENT_TYPE)
    assert ei.value.code == 400
    assert "expected item shape" in json.loads(ei.value.read())["error"]


def test_bad_body_is_400(served):
    _, _, base = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/infer", b"not npy or json", NPY_CONTENT_TYPE)
    assert ei.value.code == 400


def test_bf16_output_is_portable():
    """A bf16 engine's rows reach the wire as float32 (numpy has no
    bfloat16: np.save and JSON would fail)."""
    graph, _, _ = build_resnet18(batch=1, image_size=32, num_classes=6,
                                 width=8)
    eng = _cpu_engine(graph, compute_dtype="bfloat16")
    svc = BatchingService(eng, max_batch=4, max_wait_ms=5)
    server, base = _serve(svc)
    try:
        x = RNG.standard_normal((32, 32, 3)).astype(np.float32)
        status, _, body = _post(base + "/v1/infer", _npy(x),
                                NPY_CONTENT_TYPE)
        assert status == 200
        got = np.load(io.BytesIO(body), allow_pickle=False)
        assert got.dtype == np.float32
        status, _, body = _post(base + "/v1/infer",
                                json.dumps({"input": x.tolist()}).encode(),
                                "application/json")
        assert status == 200 and json.loads(body)["shape"] == [6]
    finally:
        server.stop()
        svc.stop(drain=False)


def test_unknown_route_is_404(served):
    _, _, base = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get_json(base + "/nope")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/nope", b"{}", "application/json")
    assert ei.value.code == 404


def test_uint8_request_deterministic_under_cobatching(served):
    """uint8 items are u8_scale-normalized at the HTTP boundary, so a
    uint8 item co-batched with f32 requests gives its result alone."""
    eng, _, base = served
    import concurrent.futures as cf

    u8 = (RNG.uniform(0, 255, (32, 32, 3))).astype(np.uint8)
    want = eng.run({eng.input_names[0]:
                    (u8.astype(np.float32) / 255.0)[None]})[
        eng.output_names[0]][0]

    def post_npy(arr):
        status, _, body = _post(base + "/v1/infer", _npy(arr),
                                NPY_CONTENT_TYPE)
        assert status == 200
        return np.load(io.BytesIO(body), allow_pickle=False)

    got_alone = post_npy(u8)
    np.testing.assert_allclose(got_alone, want, atol=1e-4, rtol=1e-4)
    f32s = [RNG.standard_normal((32, 32, 3)).astype(np.float32)
            for _ in range(6)]
    with cf.ThreadPoolExecutor(max_workers=7) as ex:
        futs = [ex.submit(post_npy, a) for a in [u8] + f32s]
        got_mixed = futs[0].result()
    np.testing.assert_allclose(got_mixed, want, atol=1e-4, rtol=1e-4)


def test_oversized_request_does_not_desync_keepalive(served):
    """An early 400 (unread body) must close the connection — otherwise
    the next request on the socket is parsed from leftover body bytes."""
    _, _, base = served
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/v1/infer", body=b"x" * 10,
                     headers={"Content-Type": NPY_CONTENT_TYPE,
                              "Content-Length": str(2**40)})
        resp = conn.getresponse()
        assert resp.status == 400
        resp.read()
        try:
            conn.request("GET", "/healthz")
            resp2 = conn.getresponse()
            assert resp2.status == 200
        except (http.client.HTTPException, ConnectionError, OSError):
            pass  # closed connection is the expected behavior
    finally:
        conn.close()


def test_generate_is_400_without_a_generation_service(served):
    """/v1/generate answers as the JAX server does with no generation
    service attached; attaching one is not ported yet."""
    eng, svc, base = served
    body = json.dumps({"prompt": [1, 2, 3], "max_new": 4}).encode()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/generate", body, "application/json")
    assert ei.value.code == 400
    assert "no generation service attached" in json.loads(
        ei.value.read())["error"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceServer(svc, port=0, gen_service=object())
    with pytest.raises(ValueError):
        InferenceServer(None, port=0)


# ----------------------------------------------------------- /v1/detect
@pytest.fixture(scope="module")
def detect_served():
    from simpleinfer_tpu_torch.zoo.detect import decode_device

    graph, _, _ = build_yolov5("n", batch=1, image_size=64)
    svc = BatchingService(_cpu_engine(graph), max_batch=4, max_wait_ms=5)
    server, base = _serve(svc)
    graph2, _, _ = build_yolov5("n", batch=1, image_size=64)
    svc2 = BatchingService(
        _cpu_engine(graph2), max_batch=4, max_wait_ms=5,
        device_postprocess=lambda o: decode_device(
            o, conf_thresh=0.01, max_det=64))
    server2, base2 = _serve(svc2)
    yield base, base2
    server.stop()
    svc.stop(drain=False)
    server2.stop()
    svc2.stop(drain=False)


def _detect_json(base, img, query=""):
    body = json.dumps({"image": img.tolist()}).encode()
    return _post(base + "/v1/detect" + query, body, "application/json")


def test_detect_endpoint_host_decode(detect_served):
    base, _ = detect_served
    img = RNG.integers(0, 255, (48, 72, 3)).astype(np.uint8)
    status, ctype, body = _detect_json(base, img, "?conf=0.01")
    assert status == 200 and ctype.startswith("application/json")
    out = json.loads(body)
    assert out["count"] == len(out["detections"]) > 0
    for d in out["detections"]:
        x1, y1, x2, y2 = d["box"]
        assert 0 <= x1 <= 72 and 0 <= y2 <= 48
        assert 0 < d["score"] <= 1 and isinstance(d["class_name"], str)


def test_detect_endpoint_npy_body(detect_served):
    base, _ = detect_served
    img = RNG.integers(0, 255, (40, 40, 3)).astype(np.uint8)
    status, _, body = _post(base + "/v1/detect?conf=0.01", _npy(img),
                            NPY_CONTENT_TYPE)
    assert status == 200
    assert json.loads(body)["count"] >= 0


def test_detect_endpoint_device_decoded_rows(detect_served):
    base_host, base_dev = detect_served
    img = RNG.integers(0, 255, (48, 72, 3)).astype(np.uint8)
    _, _, hb = _detect_json(base_host, img, "?conf=0.01")
    _, _, db = _detect_json(base_dev, img)
    host_dets = json.loads(hb)["detections"]
    dev_dets = json.loads(db)["detections"]
    # device decode caps at max_det=64; both paths agree on the top rows
    n = min(len(host_dets), len(dev_dets))
    assert n > 0
    for a, b in zip(host_dets[:n], dev_dets[:n]):
        assert a["class_id"] == b["class_id"]
        assert abs(a["score"] - b["score"]) < 1e-3


def test_detect_endpoint_bad_image_is_400(detect_served):
    base, _ = detect_served
    img = RNG.integers(0, 255, (8, 8)).astype(np.uint8)  # not HWC
    with pytest.raises(urllib.error.HTTPError) as ei:
        _detect_json(base, img)
    assert ei.value.code == 400
    assert "HWC" in json.loads(ei.value.read())["error"]


def test_detect_endpoint_on_classifier_errors(served):
    _, _, base = served  # resnet service: item is square, decode fails
    img = RNG.integers(0, 255, (20, 20, 3)).astype(np.uint8)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _detect_json(base, img, "?conf=0.5")
    # classifier output rows don't decode; server must answer, not hang
    assert ei.value.code in (400, 500)


def test_detect_endpoint_single_class_raw_rows_host_decoded():
    """A 1-class yolov5 raw head row is 6 columns wide — the server
    must branch on service configuration (device_post), not row shape,
    or raw xywh rows get misread as decoded xyxy."""
    graph, _, _ = build_yolov5("n", batch=1, image_size=64,
                               num_classes=1)
    svc = BatchingService(_cpu_engine(graph), max_batch=2, max_wait_ms=5)
    server, base = _serve(svc)
    try:
        img = RNG.integers(0, 255, (48, 72, 3)).astype(np.uint8)
        _, _, body = _detect_json(base, img, "?conf=0.01")
        out = json.loads(body)
        assert out["count"] > 0
        # host decode ran: boxes are inside the image, class ids valid
        for d in out["detections"]:
            x1, y1, x2, y2 = d["box"]
            assert 0 <= x1 <= x2 <= 72 and 0 <= y1 <= y2 <= 48
            assert d["class_id"] == 0
            assert 0 < d["score"] <= 1
    finally:
        server.stop()
        svc.stop(drain=False)


def test_detect_endpoint_bad_query_param_is_400(detect_served):
    base, _ = detect_served
    img = RNG.integers(0, 255, (20, 20, 3)).astype(np.uint8)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _detect_json(base, img, "?conf=abc")
    assert ei.value.code == 400
    assert "conf" in json.loads(ei.value.read())["error"]


# ---- the JAX package's server and the port's -----------------------------
def _both(jgraph, tgraph, **svc_kw):
    """A JAX server and a port server over the same graph and weights."""
    jpost = svc_kw.pop("jax_post", None)
    tpost = svc_kw.pop("port_post", None)
    jsvc = JBatchingService(JEngine().load_model(None, graph=jgraph),
                            device_postprocess=jpost, **svc_kw).start()
    jserver = JInferenceServer(jsvc, port=0).start()
    tsvc = BatchingService(_cpu_engine(tgraph), device_postprocess=tpost,
                           **svc_kw)
    tserver, tbase = _serve(tsvc)
    jbase = "http://%s:%d" % jserver.address[:2]
    return (jbase, tbase), (jserver, jsvc, tserver, tsvc)


def _close(*parts):
    jserver, jsvc, tserver, tsvc = parts
    jserver.stop()
    jsvc.stop(drain=False)
    tserver.stop()
    tsvc.stop(drain=False)


def test_infer_npy_matches_the_jax_server():
    (jbase, tbase), parts = _both(
        jbuild_resnet18(batch=1, image_size=32, num_classes=6, width=8,
                        seed=4)[0],
        build_resnet18(batch=1, image_size=32, num_classes=6, width=8,
                       seed=4)[0], max_batch=4, max_wait_ms=5)
    try:
        rng = np.random.default_rng(11)
        for x in (rng.standard_normal((32, 32, 3)).astype(np.float32),
                  rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)):
            got, want = (np.load(io.BytesIO(_post(
                b + "/v1/infer", _npy(x), NPY_CONTENT_TYPE)[2]))
                for b in (tbase, jbase))
            assert got.dtype == want.dtype == np.float32
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, atol=GOLDEN_TOL * scale,
                                       rtol=GOLDEN_TOL * scale)
    finally:
        _close(*parts)


def _assert_dets_match(got, want, floor):
    assert len(got) == len(want) >= floor
    scale = max([1.0] + [abs(v) for d in want for v in d["box"]])
    for g, w in zip(got, want):
        assert g["class_id"] == w["class_id"]
        assert g["class_name"] == w["class_name"]
        tol = GOLDEN_TOL * scale
        np.testing.assert_allclose(g["box"], w["box"], atol=tol, rtol=tol)
        assert abs(g["score"] - w["score"]) <= GOLDEN_TOL * (
            1 + abs(w["score"]))


@pytest.mark.parametrize("device_decode", [False, True],
                         ids=["host_decode", "device_decode"])
def test_detect_matches_the_jax_server(device_decode):
    """/v1/detect on YOLOv5n-64 fp32 through both servers, the same
    images (mixed sizes, uint8, npy and JSON bodies): the same
    detections, in order."""
    from simpleinfer_tpu.zoo.detect import decode_device as jdecode
    from simpleinfer_tpu_torch.zoo.detect import decode_device as tdecode

    kw = dict(max_batch=4, max_wait_ms=5)
    if device_decode:
        kw.update(jax_post=lambda o: jdecode(o, max_det=300),
                  port_post=lambda o: tdecode(o, max_det=300))
    (jbase, tbase), parts = _both(
        jbuild_yolov5("n", batch=1, image_size=64)[0],
        build_yolov5("n", batch=1, image_size=64)[0], **kw)
    rng = np.random.default_rng(12)
    try:
        total = 0
        for i, (h, w) in enumerate([(48, 72), (80, 60), (64, 64)]):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            if i % 2:
                got, want = (json.loads(_post(
                    b + "/v1/detect", _npy(img), NPY_CONTENT_TYPE)[2])
                    for b in (tbase, jbase))
            else:
                got, want = (json.loads(_detect_json(b, img)[2])
                             for b in (tbase, jbase))
            assert got["count"] == len(got["detections"])
            _assert_dets_match(got["detections"], want["detections"], 1)
            total += got["count"]
        assert total >= 100
    finally:
        _close(*parts)
