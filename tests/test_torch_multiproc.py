"""parallel/multiproc.py of the port: the multi-host layer executed as
REAL separate processes (the cases of tests/test_multiproc.py).

One `multiproc.dryrun_multichip(4)` for the module, through
chip_smoke's `multiproc` phase: its compositions on 4 gloo ranks on the
CPU, then each task `launch`ed on 2 hosts x 2 ranks, which must agree
on every rank (launch asserts it) and with one process: the port's
single-process run and the JAX package's."""
import json
import os
import sys

import numpy as np
import pytest
import torch

import simpleinfer_tpu.zoo as jzoo
import simpleinfer_tpu_torch.zoo as tzoo
from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JConfig
from simpleinfer_tpu import MeshConfig as JMesh
from simpleinfer_tpu.zoo.generate import CachedDecoder as JDecoder
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.parallel import multiproc
from simpleinfer_tpu_torch.serving.batcher import BatchingService
from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def dryrun():
    return chip_smoke.multiproc_phase(torch.device("cpu"))


@pytest.fixture(scope="module")
def cnn_result(dryrun):
    return dryrun["tasks"]["cnn"]


def test_multiproc_cnn_runs_as_two_hosts(cnn_result):
    assert int(cnn_result["process_count"]) == 2
    assert int(cnn_result["n_global_devices"]) == 4
    # data = 4 ranks / model 2; every host fed only its own row
    assert cnn_result["batch_check"].shape[0] == 2


def test_multiproc_cnn_matches_one_process(cnn_result):
    """The 2-host DP x TP yolov5n forward equals the same model in one
    process — the port's single engine and the JAX mesh engine of the
    same shape — with the host-local rows stitched back bit-equal."""
    data = 2
    full = (np.arange(data * 64 * 64 * 3, dtype=np.float32)
            .reshape(data, 64, 64, 3) % 17) / 17.0
    np.testing.assert_array_equal(cnn_result["batch_check"], full)
    graph, i, o = tzoo.build_yolov5("n", batch=data, image_size=64, seed=0)
    want = Engine(EngineConfig(device="cpu")).load_model(
        None, graph=graph).run({i: full})[o]
    jgraph, ji, jo = jzoo.build_yolov5("n", batch=data, image_size=64,
                                       seed=0)
    jwant = JEngine(JConfig(mesh=JMesh(data=data, model=2))).load_model(
        None, graph=jgraph).run({ji: full})[jo]
    got = cnn_result["out"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, jwant, rtol=1e-5, atol=1e-4)


def test_multiproc_llm_tp_decode_token_equal(dryrun):
    """Greedy TP decode with the model axis spanning all 4 ranks (2 hosts)
    streams the single-device tokens of both packages."""
    res = dryrun["tasks"]["llm_tp"]
    assert int(res["process_count"]) == 2
    prompt = [[3, 1, 4, 1, 5]]
    kw = dict(variant="nano", batch=1, seq_len=32, vocab_size=64, depth=2,
              width=32, num_heads=4, seed=0)
    graph, _, _ = tzoo.build_gpt(**kw)
    solo = CachedDecoder(Engine(EngineConfig(device="cpu")).load_model(
        None, graph=graph)).generate(prompt, steps=12, temperature=0.0)
    jgraph, _, _ = jzoo.build_gpt(**kw)
    jsolo = JDecoder(JEngine(JConfig()).load_model(
        None, graph=jgraph)).generate(prompt, steps=12, temperature=0.0)
    np.testing.assert_array_equal(res["tokens"], np.asarray(solo))
    np.testing.assert_array_equal(res["tokens"], np.asarray(jsolo))


def test_multiproc_cnn_serving_matches_one_process(dryrun):
    """BASELINE config 5's composition: each rank's BatchingService serves
    its own request slice through its pool of engines; the all-gathered
    stream, the bucket and padding accounting equal one process serving
    the global stream wave by wave."""
    res = dryrun["tasks"]["cnn_serving"]
    world = 4
    n = multiproc.REQS_PER_RANK
    assert (res["requests"] == n).all()
    np.testing.assert_array_equal(res["bucket_stats"],
                                  [[[4, 2, 7]]] * world)
    assert (res["padded"] == 1).all()
    np.testing.assert_array_equal(res["engines_used"], [[1, 1]] * world)
    assert res["out"].shape[0] == world * n

    engines = []
    for _ in range(multiproc.ENGINES_PER_RANK):
        graph, _i, _o = tzoo.build_yolov5("n", batch=1, image_size=64,
                                          seed=0)
        engines.append(Engine(EngineConfig(device="cpu")).load_model(
            None, graph=graph))
    svc = BatchingService(engines, max_batch=4, buckets=[1, 2, 4],
                          max_wait_ms=250.0).start()
    outs = []
    try:
        for r in range(world):
            for wave in multiproc.SERVING_WAVES:
                futs = [svc.submit(multiproc.serving_request(r * n + i))
                        for i in wave]
                outs += [f.result(timeout=120) for f in futs]
    finally:
        svc.stop()
    st = svc.stats
    assert sorted((b, s.batches, s.items)
                  for b, s in st.per_bucket.items()) == [(4, 8, 28)]
    assert st.padded_items == world
    np.testing.assert_allclose(res["out"], np.stack(outs), rtol=1e-5,
                               atol=1e-4)
    # and the JAX engine on the same requests
    jgraph, ji, jo = jzoo.build_yolov5("n", batch=4, image_size=64, seed=0)
    jeng = JEngine(JConfig()).load_model(None, graph=jgraph)
    first = np.stack([multiproc.serving_request(i) for i in range(4)])
    np.testing.assert_allclose(res["out"][:4], jeng.run({ji: first})[jo],
                               rtol=1e-5, atol=1e-4)


def test_dryrun_multichip_four_ranks(dryrun):
    """The repository's multi-chip dry run as 4 torch.distributed ranks,
    through chip_smoke's `multiproc` phase: yolov5n on data x spatial x
    model, llama micro TP decode in both tp_modes, and the three
    tasks."""
    res = dryrun
    assert res["world"] == 4 and res["backend"] == "gloo"
    assert set(res["tasks"]) == set(multiproc.TASKS)
    lines = "\n".join(res["lines"])
    assert "dryrun_multichip ok: mesh data=1 spatial=2 model=2" in lines
    assert "gspmd + ring decode token-equal" in lines
    assert "dryrun multiprocess ok" in lines


def test_chip_smoke_parallel_phases_rehearse_on_cpu(capsys):
    """chip_smoke's parallel_cnn and parallel_llm phases at a tiny size:
    2 gloo ranks, the kernels' plain versions, every check of the card's
    run (the on-card launch counts aside) and the shard-shape entries
    of the kernels line."""
    kernels = chip_smoke.parallel_rehearsal(torch.device("cpu"),
                                            with_multiproc=False)
    assert set(kernels["matmul_int8w"]) >= {"parallel_cnn", "parallel_llm"}
    for name in ("flash_attention", "decode_attention"):
        assert "parallel_llm" in kernels[name]
    # the wrappers' calls at the shard shapes (on the CPU they run the
    # plain versions, and count no launch)
    cnn = kernels["matmul_int8w"]["parallel_cnn"]
    assert cnn["shapes"] and cnn["launches"] == 0
    for name in ("matmul_int8w", "decode_attention"):
        assert kernels[name]["parallel_llm"]["shapes"], name
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    phases = {x.get("phase") for x in lines}
    assert {"parallel_cnn", "parallel_cnn_fp32_vs_cpu", "parallel_llm",
            "parallel_llm_fp32_tokens"} <= phases
    for x in lines:
        if x.get("phase") in ("parallel_cnn", "parallel_llm"):
            assert x["world"] == 2 and x["backend"] == "gloo"


def test_launch_refuses_unknown_tasks_and_missing_cards():
    with pytest.raises(ValueError, match="unknown task"):
        multiproc.launch("train")
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multiproc.launch("cnn")


def test_failing_rank_raises_with_logs():
    """A rank that fails makes the launcher raise with every rank's log
    and stop the others (no rank left waiting in a collective)."""
    with pytest.raises(RuntimeError, match="failed") as e:
        multiproc.spawn("simpleinfer_tpu_torch.parallel.multiproc:"
                        "no_such_task", 2, 1, timeout_s=60, device="cpu")
    assert "rank 0" in str(e.value) and "rank 1" in str(e.value)
