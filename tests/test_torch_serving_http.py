"""The port's HTTP front end (simpleinfer_tpu_torch/serving/http.py) on
the CPU: the scenarios of tests/test_serving_http.py against a port
server on an ephemeral port; /v1/generate (JSON, SSE, a hang-up, the
tiered service, validation and stats; tests/test_serving.py's HTTP
scenarios) on a GPT nano, its ids equal to a greedy decode and to the
JAX server's; and the JAX package's server and the
port's on the same requests: /v1/infer (npy, resnet18-32 width 8 fp32)
and /v1/detect (build_yolov5("n", image_size=64) fp32, host decode and
device decode). Parity: the same count and class ids, boxes and scores
within the golden tolerance (atol = rtol = 5e-4 x scale,
tests/test_golden.py:102, scale = max(1, |ref|) over the reply)."""
import http.client
import io
import json
import socket
import time
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
    """/v1/generate answers 400 as the JAX server does when no generation
    service is attached; a server needs at least one service, and takes
    a BatchingService and a generation service together."""
    eng, svc, base = served
    body = json.dumps({"prompt": [1, 2, 3], "max_new": 4}).encode()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/generate", body, "application/json")
    assert ei.value.code == 400
    assert "no generation service attached" in json.loads(
        ei.value.read())["error"]
    both = InferenceServer(svc, port=0, gen_service=_gen_service())
    assert both.gen_service is not None and both.service is svc
    both._httpd.server_close()
    with pytest.raises(ValueError):
        InferenceServer(None, port=0)


# ----------------------------------------------------------- /v1/generate
def _gpt_graph(seq_len=24):
    """tests/test_serving.py's _gpt_engine graph (GPT nano, vocab 40)."""
    from simpleinfer_tpu_torch.zoo import build_gpt

    return build_gpt(variant="nano", batch=1, seq_len=seq_len,
                     vocab_size=40, depth=2, width=32, num_heads=4)[0]


def _gen_service(seq_len=24, tiers=None, **kw):
    from simpleinfer_tpu_torch.serving import (GenerationService,
                                               TieredGenerationService)

    eng = _cpu_engine(_gpt_graph(seq_len), use_kernels=True)
    if tiers:
        return TieredGenerationService(eng, tiers=tiers, decode_horizon=2,
                                       **kw)
    return GenerationService(eng, slots=2, decode_horizon=2, **kw)


@pytest.fixture(scope="module")
def gen_served():
    gsvc = _gen_service().start()
    server = InferenceServer(None, port=0, gen_service=gsvc).start()
    host, port = server.address[:2]
    yield gsvc, f"http://{host}:{port}"
    server.stop()
    gsvc.stop()


def _sse_events(resp) -> list:
    return [json.loads(line.decode().strip()[6:]) for line in resp
            if line.startswith(b"data: ")]


def test_generate_endpoint(gen_served):
    """JSON /v1/generate: the ids equal a CachedDecoder's greedy decode
    of the prompt, and the JAX server's reply on the same graph."""
    from simpleinfer_tpu import Engine as JE
    from simpleinfer_tpu.serving.llm import GenerationService as JGen
    from simpleinfer_tpu.zoo import build_gpt as jbuild_gpt
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    _, base = gen_served
    want = CachedDecoder(_cpu_engine(_gpt_graph(), use_kernels=True)
                         ).generate(np.asarray([[3, 7, 11]]), steps=5)[0]
    body = json.dumps({"prompt": [3, 7, 11], "max_new": 5}).encode()
    status, ctype, out = _post(base + "/v1/generate", body,
                               "application/json")
    assert status == 200 and ctype == "application/json"
    payload = json.loads(out)
    assert payload["prompt_len"] == 3
    np.testing.assert_array_equal(payload["ids"], want)
    jg = jbuild_gpt(variant="nano", batch=1, seq_len=24, vocab_size=40,
                    depth=2, width=32, num_heads=4)[0]
    jsvc = JGen(JE().load_model(None, graph=jg), slots=2,
                decode_horizon=2).start()
    jserver = JInferenceServer(None, port=0, gen_service=jsvc).start()
    try:
        _, _, jout = _post(f"http://127.0.0.1:{jserver.address[1]}"
                           "/v1/generate", body, "application/json")
    finally:
        jserver.stop()
        jsvc.stop()
    assert json.loads(jout) == payload


def test_generate_validation_and_stats(gen_served):
    """400 on a body without a prompt, on a bad parameter, on an npy
    body and on a prompt past the window; /v1/infer is 400 on a
    generation-only server; /v1/stats and /metrics carry the generation
    counters."""
    _, base = gen_served
    for body in ({"max_new": 5}, {"prompt": [1, 2], "top_k": "many"},
                 {"prompt": [1] * 20, "max_new": 10}, [1, 2, 3]):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/v1/generate", json.dumps(body).encode(),
                  "application/json")
        assert ei.value.code == 400, body
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/generate", _npy(np.ones(3)), NPY_CONTENT_TYPE)
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/v1/infer", json.dumps({"input": [1.0]}).encode(),
              "application/json")
    assert ei.value.code == 400
    _post(base + "/v1/generate", json.dumps(
        {"prompt": [4, 2], "max_new": 5}).encode(), "application/json")
    status, stats = _get_json(base + "/v1/stats")
    assert status == 200 and stats["tokens_out"] >= 5
    assert {"capped_steps", "cancelled", "timed_out"} <= set(stats)
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    assert "si_gen_tokens_total" in text
    assert "si_gen_cancelled_total" in text


def test_generate_sse_stream(gen_served):
    """stream=true: one SSE event a token, then a done event with the
    full ids (equal to the JSON reply's)."""
    _, base = gen_served
    body = {"prompt": [4, 8, 1], "max_new": 7}
    _, _, out = _post(base + "/v1/generate", json.dumps(body).encode(),
                      "application/json")
    want = json.loads(out)["ids"]
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(
            {**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        events = _sse_events(resp)
    toks = [e["token"] for e in events if "token" in e]
    done = [e for e in events if e.get("done")]
    assert len(done) == 1
    assert done[0]["ids"] == want and done[0]["prompt_len"] == 3
    assert toks == want[3:]


def test_generate_sse_hangup_frees_the_slot():
    """A client that reads two SSE events and hangs up cancels its
    request: the row is freed before max_new, counted as cancelled, and
    the next request is served in full."""
    gsvc = _gen_service(seq_len=64)
    orig = gsvc._dec.decode_block

    def slow_block(*a, **kw):       # a block takes 10 ms, as on a card
        time.sleep(0.01)
        return orig(*a, **kw)
    gsvc._dec.decode_block = slow_block
    gsvc.start()
    server = InferenceServer(None, port=0, gen_service=gsvc).start()
    host, port = server.address[:2]
    try:
        body = json.dumps({"prompt": [4, 8], "max_new": 60,
                           "stream": True}).encode()
        sock = socket.create_connection((host, port), timeout=60)
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body) + body)
        reader = sock.makefile("rb")
        seen = 0
        while seen < 2:
            if reader.readline().startswith(b"data: "):
                seen += 1
        reader.close()
        sock.close()
        for _ in range(500):
            if gsvc.stats.completed:
                break
            time.sleep(0.01)
        assert gsvc.stats.cancelled == 1
        assert gsvc.stats.tokens_out < 60
        _, _, out = _post(f"http://{host}:{port}/v1/generate", json.dumps(
            {"prompt": [1, 2], "max_new": 6}).encode(), "application/json")
        assert len(json.loads(out)["ids"]) == 8
    finally:
        server.stop()
        gsvc.stop()


def test_generate_with_tiered_service():
    """TieredGenerationService behind the server: short and long requests
    go through their tiers, deadlines and priorities pass through, and
    /v1/stats sums the tiers."""
    gsvc = _gen_service(tiers=((2, 12), (2, None))).start()
    server = InferenceServer(None, port=0, gen_service=gsvc).start()
    base = f"http://127.0.0.1:{server.address[1]}"
    try:
        def gen(prompt, max_new, **kw):
            _, _, out = _post(base + "/v1/generate", json.dumps(
                {"prompt": prompt, "max_new": max_new, **kw}).encode(),
                "application/json")
            return json.loads(out)

        short = gen([4, 8], 5, priority=3)
        long_ = gen([3, 1, 4, 1, 5, 9], 14, timeout_s=60)
        assert len(short["ids"]) == 7 and len(long_["ids"]) == 20
        _, stats = _get_json(base + "/v1/stats")
    finally:
        server.stop()
        gsvc.stop()
    assert [s.stats.completed for s in gsvc.services] == [1, 1]
    assert stats["completed"] == 2


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
