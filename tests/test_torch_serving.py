"""The port's continuous batching service
(simpleinfer_tpu_torch/serving/batcher.py) on the CPU: the scenarios of
tests/test_serving.py against port engines, the pipeline's ordering and
failure rules, its staging helpers, and the same seeded items through
the JAX package's service and the port's (resnet18-32 width 8 fp32,
within the golden tolerance, atol = rtol = 5e-4 x scale,
tests/test_golden.py:102).

A request's row is its batch's row: within 1e-4 of a direct
Engine.run over the same items (the port's fp32 CPU forwards differ
only in the order of sums between batch sizes)."""
import os
import sys
import threading

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu.serving import BatchingService as JBatchingService
from simpleinfer_tpu.zoo import build_resnet18 as jbuild_resnet18
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.serving import BatchingService
from simpleinfer_tpu_torch.serving import batcher
from simpleinfer_tpu_torch.zoo import build_resnet18

RNG = np.random.default_rng(31)
GOLDEN_TOL = 5e-4


def _engine(seed=0):
    graph, _, _ = build_resnet18(batch=1, image_size=32, num_classes=6,
                                 width=8, seed=seed)
    return Engine(EngineConfig(device="cpu")).load_model(None, graph=graph)


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _items(n, rng=RNG):
    return [rng.standard_normal((32, 32, 3)).astype(np.float32)
            for _ in range(n)]


def _ref_outputs(engine, items):
    out = engine.run({engine.input_names[0]: np.stack(items)})
    return out[engine.output_names[0]]


def test_single_request(engine):
    svc = BatchingService(engine, max_batch=4).start()
    try:
        x = _items(1)[0]
        got = svc.submit(x).result(timeout=60)
        want = _ref_outputs(engine, [x])[0]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    finally:
        svc.stop()


def test_requests_batched_and_correct(engine):
    svc = BatchingService(engine, max_batch=8, max_wait_ms=50).start()
    try:
        xs = _items(16)
        futs = [svc.submit(x) for x in xs]
        got = np.stack([f.result(timeout=120) for f in futs])
        want = _ref_outputs(engine, xs)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        assert svc.stats.requests == 16
        # 16 requests at max_batch 8 with a 50ms gather window should use
        # far fewer than 16 batches
        assert svc.stats.batches < 16
    finally:
        svc.stop()


def test_bucket_padding_accounting(engine):
    svc = BatchingService(engine, max_batch=8, buckets=[1, 4, 8],
                          max_wait_ms=100).start()
    try:
        futs = [svc.submit(x) for x in _items(3)]
        for f in futs:
            f.result(timeout=120)
        svc.stop()
        # 3 requests can't exceed one bucket-4 batch (plus maybe splits);
        # padding must be recorded whenever a bucket was not exactly full
        assert svc.stats.requests == 3
        assert svc.stats.padded_items >= 1
        assert 0 < svc.stats.mean_batch_occupancy <= 1.0
    finally:
        svc.stop()


def test_concurrent_submitters(engine):
    """Many client threads submit concurrently; the engine itself is
    owned solely by the service thread (submit() is the thread-safe
    surface), so references are computed after the service drains."""
    svc = BatchingService(engine, max_batch=8, max_wait_ms=10).start()
    results: dict = {}
    errs = []

    def client(seed):
        try:
            x = _items(1, np.random.default_rng(seed))[0]
            results[seed] = (x, svc.submit(x).result(timeout=120))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    svc.stop()
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert len(results) == 12
    xs = [results[i][0] for i in sorted(results)]
    want = _ref_outputs(engine, xs)
    got = np.stack([results[i][1] for i in sorted(results)])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_device_postprocess(engine):
    """The postprocess (a torch callable) runs on the output tensor
    before the host fetch, under inference mode."""
    seen = []

    def post(o):
        seen.append((type(o), torch.is_inference_mode_enabled()))
        return o[:, :3] * 2.0

    svc = BatchingService(engine, max_batch=4, device_postprocess=post)
    svc.start()
    try:
        x = _items(1)[0]
        got = svc.submit(x).result(timeout=60)
        want = _ref_outputs(engine, [x])[0][:3] * 2.0
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        assert seen == [(torch.Tensor, True)]
    finally:
        svc.stop()


def test_topk_candidates():
    from simpleinfer_tpu_torch.zoo.detect import topk_candidates

    pred = np.zeros((2, 100, 85), np.float32)
    pred[0, 7, 4] = 0.9
    pred[0, 7, 5] = 1.0  # top row image 0
    pred[1, 42, 4] = 0.8
    pred[1, 42, 9] = 1.0
    out = topk_candidates(torch.from_numpy(pred), k=5).numpy()
    assert out.shape == (2, 5, 85)
    assert out[0, 0, 4] == np.float32(0.9)
    assert out[1, 0, 4] == np.float32(0.8)


def test_error_propagates_to_future(engine):
    svc = BatchingService(engine, max_batch=2).start()
    try:
        bad = np.zeros((7, 7), np.float32)  # wrong rank -> engine raises
        with pytest.raises(ValueError, match="rank"):
            svc.submit(bad).result(timeout=60)
    finally:
        svc.stop(drain=False)


def test_multi_engine_pool_round_robins(engine):
    """Engine pool: batches spread across engines, results stay
    correct."""
    eng2 = _engine()
    # same weights on both replicas so outputs are comparable
    eng2._device_weights = engine._device_weights
    svc = BatchingService([engine, eng2], max_batch=2,
                          max_wait_ms=1.0).start()
    try:
        xs = _items(12)
        futs = [svc.submit(x) for x in xs]
        got = np.stack([f.result(timeout=120) for f in futs])
        want = _ref_outputs(engine, xs)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        # both engines must have been used
        assert all(b > 0 for b in svc.stats.batches_per_engine)
        assert sum(svc.stats.batches_per_engine) == svc.stats.batches
    finally:
        svc.stop()


def test_device_pinned_engines_pool_of_two_cpu_engines():
    """The JAX test pins two engines to two devices of a simulated
    slice; here a pool of two CPU engines of one graph: each keeps its
    weights and outputs on its own device and both give the same
    rows, alone and as the service's pool."""
    graph, in_name, out_name = build_resnet18(batch=1, image_size=32,
                                              num_classes=6, width=8)
    engines = [Engine(EngineConfig(device="cpu")).load_model(None,
                                                              graph=graph)
               for _ in range(2)]
    x = RNG.standard_normal((2, 32, 32, 3)).astype(np.float32)
    outs = []
    for eng in engines:
        eng.input(in_name, x)
        eng.forward()
        out = eng.extract(out_name, as_numpy=False)
        assert out.device == eng.device == torch.device("cpu")
        outs.append(out.numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=1e-5)
    svc = BatchingService(engines, max_batch=1).start()
    try:
        rows = [f.result(timeout=60) for f in [svc.submit(r) for r in x]]
    finally:
        svc.stop()
    assert svc.stats.batches_per_engine == [1, 1]
    np.testing.assert_allclose(np.stack(rows), outs[0], atol=1e-4,
                               rtol=1e-4)


def test_multi_engine_pool_pinned_devices():
    """A pool of four engines, round-robin dispatch, the pipeline four
    deep, per-request latency and occupancy accounted."""
    graph, _, _ = build_resnet18(batch=1, image_size=32, num_classes=6,
                                 width=8, seed=5)
    engines = [Engine(EngineConfig(device="cpu")).load_model(None,
                                                              graph=graph)
               for _ in range(4)]
    svc = BatchingService(engines, max_batch=4, buckets=[1, 2, 4],
                          max_wait_ms=1.0).start()
    try:
        xs = _items(24)
        futs = [svc.submit(x) for x in xs]
        got = np.stack([f.result(timeout=120) for f in futs])
        want = _ref_outputs(engines[0], xs)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        # every engine took batches; totals reconcile
        assert all(b > 0 for b in svc.stats.batches_per_engine)
        assert sum(svc.stats.batches_per_engine) == svc.stats.batches
        assert svc.stats.requests == len(xs)
        # per-request latency was recorded (mean > 0) and the bucket
        # SLO report covers every bucket used
        assert svc.stats.mean_latency_ms > 0
        report = svc.stats.slo_report(target_ms=60_000)
        assert sum(s["items"] for s in report.values()) == len(xs)
        assert all(s["within"] for s in report.values())
        # occupancy: bucketing never padded more than it served
        assert svc.stats.mean_batch_occupancy > 0.5
    finally:
        svc.stop()


def test_temp_bytes_report(engine):
    """Engine.temp_bytes is None on the CPU (no allocator statistics):
    the spill probe then keeps every bucket."""
    assert engine.temp_bytes(2) is None
    svc = BatchingService(engine, max_batch=8)
    svc.warmup(probe_spill=True)
    assert svc.buckets == [1, 2, 4, 8] and svc.max_batch == 8


def test_warmup_spill_probe_drops_spilled_buckets(engine, monkeypatch):
    """Buckets whose forwards hold more temporaries than the budget
    (SPILL_BUDGET_BYTES by default) are dropped: a b16 offered load is
    then served as b8 waves."""
    svc = BatchingService(engine, max_batch=16, buckets=[1, 4, 8, 16],
                          max_wait_ms=20.0)
    spill = {1: 0, 4: 0, 8: batcher.SPILL_BUDGET_BYTES,
             16: batcher.SPILL_BUDGET_BYTES + 1}
    monkeypatch.setattr(engine, "temp_bytes", lambda b: spill[b])
    svc.warmup(probe_spill=True)
    assert svc.buckets == [1, 4, 8]
    assert svc.max_batch == 8
    svc.start()
    try:
        xs = _items(16)
        futs = [svc.submit(x) for x in xs]
        got = np.stack([f.result(timeout=120) for f in futs])
        np.testing.assert_allclose(got, _ref_outputs(engine, xs),
                                   atol=1e-4, rtol=1e-4)
        # nothing dispatched above the capped bucket
        assert max(svc.stats.per_bucket) <= 8
    finally:
        svc.stop()
    # an explicit budget (the JAX package's 32 MB) drops more
    svc = BatchingService(engine, max_batch=16, buckets=[1, 4, 8, 16])
    spill = {1: 0, 4: 32 << 20, 8: (32 << 20) + 1, 16: 0}
    monkeypatch.setattr(engine, "temp_bytes", lambda b: spill[b])
    svc.warmup(probe_spill=True, spill_budget_bytes=32 << 20)
    assert svc.buckets == [1, 4, 16] and svc.max_batch == 16


def test_multi_engine_single_is_default(engine):
    svc = BatchingService(engine, max_batch=4)
    assert svc.engines == [engine]
    assert svc.stats.batches_per_engine == [0]


def test_failed_dispatches_do_not_starve_inflight(engine):
    """A stream of malformed requests must not withhold results of
    batches the device already computed (the failure path resolves the
    oldest in-flight batch too)."""
    svc = BatchingService(engine, max_batch=1, max_wait_ms=1.0).start()
    try:
        good = svc.submit(_items(1)[0])
        bads = [svc.submit(np.zeros(3, np.float32)) for _ in range(8)]
        got = good.result(timeout=60)  # must resolve despite bad stream
        assert got.shape[-1] == 6
        for b in bads:
            with pytest.raises(Exception):
                b.result(timeout=60)
    finally:
        svc.stop(drain=False)


def test_per_bucket_latency_stats_and_slo(engine):
    svc = BatchingService(engine, max_batch=4, buckets=[1, 4],
                          max_wait_ms=1.0).start()
    try:
        for f in [svc.submit(x) for x in _items(6)]:
            f.result(timeout=60)
        assert svc.stats.per_bucket  # at least one bucket used
        total_items = sum(b.items for b in svc.stats.per_bucket.values())
        assert total_items == 6
        rep = svc.stats.slo_report(target_ms=60_000)
        assert all(v["within"] for v in rep.values())
        rep_tight = svc.stats.slo_report(target_ms=0.0)
        assert not any(v["within"] for v in rep_tight.values())
    finally:
        svc.stop()


# ---- the pipeline: ordering, failures, stop -----------------------------
@pytest.mark.parametrize("pool", [1, 2])
def test_each_future_gets_its_own_row_under_the_pipeline(engine, pool):
    """Batches of mixed sizes (bucket padding) in flight 1 and 2 deep:
    every future resolves with its own item's row, and a malformed item
    fails only the futures of its own batch."""
    engines = [engine] + [_engine() for _ in range(pool - 1)]
    for e in engines[1:]:
        e._device_weights = engine._device_weights
    svc = BatchingService(engines, max_batch=4, buckets=[1, 2, 4],
                          max_wait_ms=0.0).start()
    rng = np.random.default_rng(pool)
    try:
        xs = _items(23, rng)
        futs, bad = [], None
        for i, x in enumerate(xs):
            futs.append(svc.submit(x))
            if i == 11:
                bad = svc.submit(np.zeros((5, 5, 3), np.float32))
        with pytest.raises(ValueError):
            bad.result(timeout=60)
        got = {i: f.result(timeout=60) for i, f in enumerate(futs)
               if f.exception(timeout=60) is None}
    finally:
        svc.stop()
    # only the bad item's batch may fail (it shares no batch: its shape
    # differs, so the stack raises for every item of that batch)
    assert len(got) >= len(xs) - 3
    want = _ref_outputs(engine, xs)
    for i, row in got.items():
        np.testing.assert_allclose(row, want[i], atol=1e-4, rtol=1e-4)
    assert svc.stats.requests == len(xs) + 1
    assert sum(svc.stats.batches_per_engine) <= svc.stats.batches


def test_stop_without_drain_keeps_bucket_stats_consistent(engine):
    """stop(drain=False) after part of a load: every dispatched batch is
    resolved before the thread exits, and the per-bucket items add up to
    the requests the stats count (no batch failed)."""
    svc = BatchingService(engine, max_batch=4, buckets=[1, 2, 4],
                          max_wait_ms=0.0).start()
    futs = [svc.submit(x) for x in _items(40)]
    futs[5].result(timeout=60)
    svc.stop(drain=False)
    done = [f for f in futs if f.done()]
    assert all(f.exception() is None for f in done)
    s = svc.stats
    assert s.requests == len(done) >= 6
    assert sum(b.items for b in s.per_bucket.values()) == s.requests
    assert sum(b.batches for b in s.per_bucket.values()) == s.batches
    assert s.padded_items == sum(b * st.batches for b, st in
                                 s.per_bucket.items()) - s.requests


# ---- staging and fetch helpers ------------------------------------------
def test_stage_batch_pads_promotes_and_checks_shapes():
    a = np.arange(6, dtype=np.uint8).reshape(2, 3)
    b = np.ones((2, 3), np.float32)
    out = batcher.stage_batch([a, b], 4, pin=False)
    want = np.concatenate([np.stack([a, b]), np.zeros((2, 2, 3))])
    assert out.dtype == np.float32 and out.shape == (4, 2, 3)
    np.testing.assert_array_equal(out, want)
    u8 = batcher.stage_batch([a], 1, pin=False)
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8[0], a)
    with pytest.raises(ValueError):
        batcher.stage_batch([a, np.ones((3, 2), np.float32)], 2, pin=False)


def test_fetch_async_on_the_cpu_converts_bf16():
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    host, done = batcher.fetch_async(t)
    assert done is None and host.dtype == torch.float32
    np.testing.assert_array_equal(host.numpy(), t.float().numpy())
    f32 = torch.ones(3)
    assert batcher.fetch_async(f32) == (f32, None)


def test_bf16_engine_rows_come_back_float32():
    graph, _, _ = build_resnet18(batch=1, image_size=32, num_classes=6,
                                 width=8)
    eng = Engine(EngineConfig(device="cpu", compute_dtype="bfloat16")
                 ).load_model(None, graph=graph)
    svc = BatchingService(eng, max_batch=2).start()
    try:
        row = svc.submit(_items(1)[0]).result(timeout=60)
    finally:
        svc.stop()
    assert row.dtype == np.float32 and row.shape == (6,)


# ---- the JAX package's service and the port's ---------------------------
def test_service_rows_match_the_jax_service():
    """The same seeded items through the JAX BatchingService and the
    port's (resnet18-32 width 8, fp32, the same graph and weights):
    each request's row within the golden tolerance."""
    jgraph, _, _ = jbuild_resnet18(batch=1, image_size=32, num_classes=6,
                                   width=8, seed=3)
    jeng = JEngine().load_model(None, graph=jgraph)
    teng = _engine(seed=3)
    xs = _items(13, np.random.default_rng(2024))
    rows = []
    for svc in (JBatchingService(jeng, max_batch=4, max_wait_ms=5),
                BatchingService(teng, max_batch=4, max_wait_ms=5)):
        svc.start()
        try:
            rows.append(np.stack([np.asarray(f.result(timeout=120))
                                  for f in [svc.submit(x) for x in xs]]))
        finally:
            svc.stop()
        assert svc.stats.requests == len(xs)
    want, got = rows
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=GOLDEN_TOL * scale,
                               rtol=GOLDEN_TOL * scale)


def test_chip_smoke_serving_phases_rehearse_on_cpu():
    """chip_smoke.py's serving and serving_http phases at 64 px on the
    CPU: one b8 batch equal to the serial loop's rows, 22 matmul_int8w
    calls in the service's forward, the client process's posts all
    answered and counted, one image alone equal to detect_images."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    out = chip_smoke.serving_rehearsal(torch.device("cpu"))
    run, http = out["serving"], out["serving_http"]
    assert run["correct"]["one_b8_batch"]
    assert run["correct"]["vs_serial_rows"]["equal"]
    assert run["correct"]["matmul_int8w_calls_per_forward"] == 22
    assert all(r["requests"] == run["requests"] for r in run["service"])
    assert run["service"][0]["scheduler"]["nms_host_checks_per_batch"] >= 1
    assert http["non_200"] == 0
    assert http["stats_requests"] == http["sent"] == http["requests"] + 3
    assert http["alone_vs_detect_images"]["equal"]
    assert "serving" in out["kernels"]["matmul_int8w"]
