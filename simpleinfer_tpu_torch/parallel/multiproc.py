"""REAL multi-process execution of the multi-host layer (localhost): the
counterpart of simpleinfer_tpu/parallel/multiproc.py.

- `spawn(target, n_processes, devices_per_process)` starts
  n_processes x devices_per_process ranks as separate OS processes
  (`python -m simpleinfer_tpu_torch.parallel.multiproc`), host-major:
  a "host" is devices_per_process consecutive ranks. Each rank wires
  itself into the world through `multihost.initialize` on a free
  localhost port, calls `target(**kwargs)` and saves its result; the
  parent raises with every rank's log when one fails or the time runs
  out, and stops the others.
- `launch(task, ...)` runs one of TASKS as the same SPMD body on every
  rank and asserts that every rank's result is identical.
- `dryrun_multichip(n)` runs the compositions of the repository's
  multi-chip dry run (__graft_entry__.dryrun_multichip) as ranks: the
  data x spatial x model CNN mesh, LLM tensor-parallel decode in both
  tp_modes, and the three tasks.

One rank per device; ranks share a card where the host has fewer cards
than ranks (gloo then carries the collectives, as on the CPU).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

TASKS = ("cnn", "llm_tp", "cnn_serving")

# cnn_serving stream shape: each rank serves REQS_PER_RANK requests in
# two admission waves — 4 together (a full bucket-4 batch) then 3
# (bucket-4 with one padded row) — through a pool of ENGINES_PER_RANK
# engines on its device, so bucket stats are deterministic
REQS_PER_RANK = 7
SERVING_WAVES = ((0, 1, 2, 3), (4, 5, 6))
ENGINES_PER_RANK = 2


def serving_request(g: int) -> np.ndarray:
    """Deterministic HWC image for GLOBAL request index g (rank r's
    stream is indices [r*REQS_PER_RANK, (r+1)*REQS_PER_RANK)); a
    single-process reference regenerates the identical stream."""
    return ((np.arange(64 * 64 * 3, dtype=np.float32) * (g + 3)) % 23
            ).reshape(64, 64, 3) / 23.0


# --------------------------------------------------------------- launcher
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def spawn(target: str, n_processes: int = 2, devices_per_process: int = 1,
          timeout_s: float = 600.0, kwargs: dict | None = None,
          device: str = "cuda") -> list:
    """Run `target(**kwargs)` on n_processes x devices_per_process ranks;
    returns every rank's result in rank order. `target` is
    "package.module:function" or "path/to/file.py:function". device:
    "cuda" (one card a rank, ranks sharing cards where there are fewer)
    or "cpu"; the backend is NCCL when every rank has a card of its own,
    else gloo. Raises RuntimeError with the ranks' logs if
    a rank fails or `timeout_s` passes; every rank is stopped first."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("multiproc device 'cuda' requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the ranks on the CPU")
    world = n_processes * devices_per_process
    # every rank runs on this machine: NCCL only when each has a card
    backend = "nccl" if device == "cuda" and \
        world <= torch.cuda.device_count() else "gloo"
    port = _free_port()
    outdir = tempfile.mkdtemp(prefix="si_multiproc_")
    with open(os.path.join(outdir, "kwargs.pkl"), "wb") as f:
        pickle.dump(kwargs or {}, f)
    env_base = dict(os.environ)
    procs, logs = [], []
    try:
        for rank in range(world):
            env = dict(env_base,
                       SI_MP_TARGET=target, SI_MP_DEVICE=device,
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(rank),
                       # a simulated host is LOCAL_WORLD_SIZE ranks;
                       # LOCAL_RANK is the rank on this machine and
                       # picks its card
                       LOCAL_WORLD_SIZE=str(devices_per_process),
                       LOCAL_RANK=str(rank), SI_MP_BACKEND=backend,
                       SI_MP_OUT=outdir, OMP_NUM_THREADS="1")
            log = open(os.path.join(outdir, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "simpleinfer_tpu_torch.parallel.multiproc"],
                env=env, stdout=log, stderr=subprocess.STDOUT,
                cwd=_root()))
        deadline = time.monotonic() + timeout_s
        failed = timed_out = False
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                failed = True
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        if failed or timed_out:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            text = []
            for rank, (p, log) in enumerate(zip(procs, logs)):
                log.seek(0)
                text.append(f"--- rank {rank} (rc={p.returncode}) ---\n"
                            f"{log.read()[-6000:]}")
            why = "timed out" if timed_out else "failed"
            raise RuntimeError(f"multiproc {target!r} {why}:\n"
                               + "\n".join(text))
        results = []
        for rank in range(world):
            with open(os.path.join(outdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(outdir, ignore_errors=True)


def launch(task: str, n_processes: int = 2, devices_per_process: int = 2,
           timeout_s: float = 600.0, device: str = "cuda") -> dict:
    """Run `task` as n_processes x devices_per_process real ranks;
    returns rank 0's result dict (arrays + metadata) after asserting
    every rank produced an identical result (SPMD agreement). Raises
    RuntimeError with the rank logs if any rank fails — callers that
    must degrade gracefully catch it."""
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; tasks are {TASKS}")
    results = spawn(f"{__name__}:_worker_{task}", n_processes,
                    devices_per_process, timeout_s, device=device)
    r0 = results[0]
    for rank, r in enumerate(results[1:], 1):
        for k in r0:
            np.testing.assert_array_equal(
                r0[k], r[k],
                err_msg=f"rank {rank} result {k!r} diverged from rank 0 "
                        f"(SPMD runs must agree everywhere)")
    r0["n_processes"] = np.asarray(n_processes)
    r0["devices_per_process"] = np.asarray(devices_per_process)
    return r0


# ---------------------------------------------------------------- workers
def _rank_device() -> str:
    """The engines' device on this rank: "cuda" is the rank's card (the
    current device, set by worker_main; a mesh engine resolves it
    through multihost.local_device), or "cpu"."""
    return "cpu" if os.environ.get("SI_MP_DEVICE") == "cpu" else "cuda"


def _worker_cnn() -> dict:
    """DP x TP yolov5n forward; every host feeds only ITS batch rows
    (the host-local input pipeline of BASELINE config 5)."""
    from simpleinfer_tpu_torch import Engine, EngineConfig, MeshConfig
    from simpleinfer_tpu_torch.zoo import build_yolov5

    from . import multihost
    from .mesh import axis_size

    model = 2 if multihost.local_world_size() >= 2 else 1
    mesh = multihost.make_mesh(model=model)
    data = axis_size(mesh, multihost.AXIS_DATA) if mesh is not None else 1
    cfg = EngineConfig(mesh=MeshConfig(data=data, model=model),
                       compute_dtype="float32", device=_rank_device())
    graph, in_name, out_name = build_yolov5("n", batch=data,
                                            image_size=64, seed=0)
    eng = Engine(cfg).load_model(None, graph=graph)
    full = (np.arange(data * 64 * 64 * 3, dtype=np.float32)
            .reshape(data, 64, 64, 3) % 17) / 17.0
    rows = data // multihost.process_count()
    h = multihost.process_index()
    local = full[h * rows:(h + 1) * rows]
    eng.input(in_name, multihost.host_local_batch(local, eng.mesh))
    eng.forward()
    return {"out": eng.extract(out_name),
            "batch_check": multihost.process_allgather(local)}


def _worker_llm_tp() -> dict:
    """Tensor-parallel greedy decode with the model axis SPANNING every
    rank: the attention output reduces and the column gathers cross the
    process boundary."""
    import torch.distributed as dist

    from simpleinfer_tpu_torch import Engine, EngineConfig, MeshConfig
    from simpleinfer_tpu_torch.zoo import build_gpt
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    graph, _, _ = build_gpt(variant="nano", batch=1, seq_len=32,
                            vocab_size=64, depth=2, width=32,
                            num_heads=4, seed=0)
    cfg = EngineConfig(mesh=MeshConfig(model=dist.get_world_size()),
                       compute_dtype="float32", device=_rank_device())
    eng = Engine(cfg).load_model(None, graph=graph)
    toks = CachedDecoder(eng).generate([[3, 1, 4, 1, 5]], steps=12,
                                       temperature=0.0)
    return {"tokens": np.asarray(toks, np.int64)}


def _worker_cnn_serving() -> dict:
    """BASELINE config 5's shape: a CONTINUOUS-BATCHED image stream
    across ranks. Each rank runs a BatchingService over its own pool of
    ENGINES_PER_RANK engines on its device and feeds only its own
    request slice; the global result stream is all-gathered in global
    request order. Serving itself runs NO collectives: DP pools serve
    independent batches."""
    import torch.distributed as dist

    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.serving.batcher import BatchingService
    from simpleinfer_tpu_torch.zoo import build_yolov5

    from . import multihost

    rank = dist.get_rank()
    engines = []
    for _ in range(ENGINES_PER_RANK):
        graph, _in, _out = build_yolov5("n", batch=1, image_size=64,
                                        seed=0)
        engines.append(Engine(EngineConfig(
            compute_dtype="float32", device=_rank_device())).load_model(
                None, graph=graph))
    svc = BatchingService(engines, max_batch=4, buckets=[1, 2, 4],
                          max_wait_ms=250.0).start()
    outs = []
    try:
        for wave in SERVING_WAVES:
            futs = [svc.submit(serving_request(rank * REQS_PER_RANK + i))
                    for i in wave]
            outs += [f.result(timeout=300) for f in futs]
    finally:
        svc.stop()
    st = svc.stats
    return {
        "out": multihost.rank_allgather(np.stack(outs)),
        "bucket_stats": multihost.rank_allgather(np.asarray([sorted(
            (b, s.batches, s.items) for b, s in st.per_bucket.items())],
            np.int64)),
        "padded": multihost.rank_allgather(
            np.asarray([st.padded_items])),
        "requests": multihost.rank_allgather(np.asarray([st.requests])),
        "engines_used": multihost.rank_allgather(
            np.asarray([sorted(st.batches_per_engine)], np.int64)),
    }


# ------------------------------------------------------------ dry run
def _dryrun_mesh(n_devices: int) -> dict:
    """The CNN composition of __graft_entry__.dryrun_multichip on one
    rank: yolov5n-64 over a data x spatial x model mesh filling all
    three axes when n divides; then llama "micro" tensor-parallel decode
    in both tp_modes."""
    from simpleinfer_tpu_torch import Engine, EngineConfig, MeshConfig
    from simpleinfer_tpu_torch.zoo import build_llama, build_yolov5
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    dev = _rank_device()
    spatial = 2 if n_devices % 4 == 0 else 1
    model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    data = n_devices // (model * spatial)
    graph, in_name, out_name = build_yolov5("n", batch=data, image_size=64)
    eng = Engine(EngineConfig(
        mesh=MeshConfig(data=data, spatial=spatial, model=model),
        device=dev)).load_model(None, graph=graph)
    x = np.full((data, 64, 64, 3), 0.25, np.float32)
    res = {"cnn": eng.run({in_name: x})[out_name],
           "mesh": np.asarray([data, spatial, model])}
    if n_devices < 2:
        return res
    graph, _, _ = build_llama("micro", batch=1, seq_len=32, vocab_size=64)
    prompt = np.asarray([[5, 1, 8], [2, 9, 3]])
    for tp_mode in ("gspmd", "ring"):
        # a mesh spans the whole world: the model axis takes all n ranks
        eng = Engine(EngineConfig(mesh=MeshConfig(model=n_devices),
                                  tp_mode=tp_mode, device=dev)).load_model(
            None, graph=graph)
        dec = CachedDecoder(eng)
        res[f"llm_{tp_mode}"] = dec.generate(prompt, steps=6, block=3)
        res["kv_heads_rank"] = np.asarray(
            next(iter(dec.init_cache(2).values()))[0].shape[1])
    return res


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = 600.0) -> dict:
    """The repository's multi-chip dry run as torch.distributed ranks:
    the data x spatial x model yolov5n mesh (finite, equal to one
    process), llama micro TP decode in both tp_modes token-equal to one
    device, and the three TASKS on 2 hosts x 2 ranks. Returns each
    task's `launch` result."""
    from simpleinfer_tpu_torch import Engine, EngineConfig
    from simpleinfer_tpu_torch.zoo import build_llama, build_yolov5
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    res = spawn(f"{__name__}:_dryrun_mesh", n_devices, 1, timeout_s,
                {"n_devices": n_devices}, device=device)
    r0 = res[0]
    for r in res[1:]:
        for k in r0:
            np.testing.assert_array_equal(r0[k], r[k])
    data, spatial, model = (int(v) for v in r0["mesh"])
    graph, in_name, out_name = build_yolov5("n", batch=data, image_size=64)
    x = np.full((data, 64, 64, 3), 0.25, np.float32)
    want = Engine(EngineConfig(device=device)).load_model(
        None, graph=graph).run({in_name: x})[out_name]
    out = r0["cnn"]
    assert np.isfinite(out).all(), "multichip dryrun produced non-finite"
    np.testing.assert_allclose(out, want, atol=2e-4, rtol=1e-3)
    print(f"dryrun_multichip ok: mesh data={data} spatial={spatial} "
          f"model={model}, out {out.shape}", flush=True)
    if "llm_gspmd" in r0:
        graph, _, _ = build_llama("micro", batch=1, seq_len=32,
                                  vocab_size=64)
        solo = CachedDecoder(Engine(EngineConfig(device=device)).load_model(
            None, graph=graph)).generate(np.asarray([[5, 1, 8], [2, 9, 3]]),
                                         steps=6, block=3)
        for mode in ("gspmd", "ring"):
            assert np.array_equal(r0[f"llm_{mode}"], solo), \
                f"llm {mode}-TP decode tokens diverge from single-device"
        print(f"dryrun llm-tp ok: model={n_devices} mesh, gspmd + ring "
              f"decode token-equal to single-device, "
              f"{int(r0['kv_heads_rank'])} kv heads a rank", flush=True)
    tasks = {}
    for task in TASKS:
        out = tasks[task] = launch(task, n_processes=2,
                                   devices_per_process=2,
                                   timeout_s=timeout_s, device=device)
        assert int(out["process_count"]) == 2
        if task == "cnn_serving":
            assert out["out"].shape[0] == 4 * REQS_PER_RANK
    print("dryrun multiprocess ok: processes=2 devices_per_process=2, "
          "cnn + llm_tp + cnn_serving ran as torch.distributed ranks, "
          "rank results identical", flush=True)
    return tasks


# ---------------------------------------------------------------- entry
def _load_target(target: str):
    mod, _, fn = target.partition(":")
    if mod.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(mod))[0], mod)
        m = importlib.util.module_from_spec(spec)
        sys.path.insert(0, os.path.dirname(os.path.abspath(mod)))
        spec.loader.exec_module(m)
    else:
        m = importlib.import_module(mod)
    return getattr(m, fn)


def worker_main() -> int:
    """Subprocess entry (env-configured): wire the rank into the world
    through parallel.multihost — the REAL code path — run the target,
    save this rank's result."""
    import torch
    import torch.distributed as dist

    from . import multihost

    torch.set_num_threads(1)
    outdir = os.environ["SI_MP_OUT"]
    rank = int(os.environ["RANK"])
    backend = multihost.initialize(backend=os.environ["SI_MP_BACKEND"])
    if os.environ.get("SI_MP_DEVICE") == "cuda":
        torch.cuda.set_device(multihost.local_device())
    with open(os.path.join(outdir, "kwargs.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    try:
        res = _load_target(os.environ["SI_MP_TARGET"])(**kwargs)
        if isinstance(res, dict):
            res.setdefault("n_global_devices",
                           np.asarray(dist.get_world_size()))
            res.setdefault("process_count",
                           np.asarray(multihost.process_count()))
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": True, "backend": backend,
                      "world": int(os.environ["WORLD_SIZE"])}))
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
