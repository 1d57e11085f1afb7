"""The port's command line (simpleinfer_tpu_torch/tools.py, `python -m
simpleinfer_tpu_torch`) on the CPU, against the JAX package's CLI on the
same written model: `dump`, `detect` (host and device decode, static
int8), `classify` (fp32 and static int8) and `segment` print the same
lines, and `calibrate` writes the same scales (rtol 1e-4). `serve`
starts in a subprocess and answers /healthz and /v1/infer; `serve
--generate` normalizes its flags as the JAX CLI does (the same errors)
and, in a subprocess on a llama nano, answers /v1/generate. `--device`
defaults to cuda: without a card the commands raise and nothing falls
back to the CPU.

Static int8 `detect`: the JAX package runs the convs of its W-packed
path (the stem and the convs that take a packed input) on fp weights,
where the port quantizes every conv (ROADMAP.md §3). The comparison
gives the port's engine those fp weights, as tests/test_torch_int8.py
does, so that both CLIs compute the same network."""
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JCfg
from simpleinfer_tpu.tools import main as jmain
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch import tools
from simpleinfer_tpu_torch.zoo import build_resnet18, build_unet, build_yolov5
from simpleinfer_tpu_torch.zoo.imageio import imwrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(91)


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _save(graph, d, name):
    param, binf = str(d / f"{name}.pnnx.param"), str(d / f"{name}.pnnx.bin")
    graph.save(param, binf)
    return param, binf


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("m")
    rng = np.random.default_rng(91)
    images = []
    for i, (h, w) in enumerate([(80, 60), (64, 64), (50, 90)]):
        p = str(d / f"in{i}.png")
        imwrite(p, rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        images.append(p)
    return {
        "yolo": _save(build_yolov5("n", batch=1, image_size=64)[0], d, "y"),
        "resnet": _save(build_resnet18(batch=1, image_size=64,
                                       num_classes=10, width=8)[0], d, "r"),
        "unet": _save(build_unet(batch=1, image_size=32, width=8,
                                 depth=1)[0], d, "u"),
        "images": images, "dir": d}


def test_dump(models):
    want = _run(jmain, ["dump", *models["yolo"]])
    got = _run(tools.main, ["dump", *models["yolo"]])
    assert got == want
    assert "nn.Conv2d" in got and "models.yolo.Detect" in got
    assert "param" in got and "attr" in got


@pytest.mark.parametrize("extra", [[], ["--device-decode"]],
                         ids=["host_decode", "device_decode"])
def test_detect_cli_matches_jax(models, tmp_path, extra):
    args = ["detect", *models["yolo"], *models["images"], "--size", "64",
            "--dtype", "float32", *extra]
    want = _run(jmain, args)
    got = _run(tools.main, args + ["--device", "cpu", "--out",
                                   str(tmp_path)])
    lines = [ln for ln in got.splitlines() if "->" not in ln]
    assert lines == want.splitlines()
    assert got.count("detections") == 3 and len(lines) > 100
    assert sorted(os.listdir(tmp_path)) == ["in0.png", "in1.png",
                                           "in2.png"]


def test_classify_cli_matches_jax(models):
    args = ["classify", *models["resnet"], *models["images"], "--size",
            "64", "--dtype", "float32", "--topk", "3"]
    got = _run(tools.main, args + ["--device", "cpu"])
    assert got == _run(jmain, args)
    assert got.count("class ") == 9


def test_segment_cli_matches_jax(models, tmp_path):
    args = ["segment", *models["unet"], *models["images"], "--dtype",
            "float32"]
    got = _run(tools.main, args + ["--device", "cpu", "--out",
                                   str(tmp_path)])
    lines = [ln for ln in got.splitlines() if "->" not in ln]
    assert lines == _run(jmain, args).splitlines()
    assert len(lines) == 3 and all("classes" in ln for ln in lines)
    assert len(os.listdir(tmp_path)) == 3


def _jax_packed_convs(param, binf, size):
    """Names of the convs the JAX package runs on its W-packed path."""
    je = JEngine(JCfg(quant="int8")).load_model(param, binf)
    env = je.program.wrap_inputs({je.input_names[0]: jnp.zeros(
        (1, size, size, 3), jnp.float32)})
    names = []
    for impl, ins, outs in je.program.plan:
        args = [env[n] for n in ins]
        if impl.type == "nn.Conv2d" and (
                impl.stem_pack_info is not None
                or any(type(a).__name__ == "PackedW" for a in args)):
            names.append(impl.name)
        out = impl.apply(je._device_weights[impl.name], *args)
        env.update(zip(outs, [out] if impl.n_outputs == 1 else list(out)))
    return names


def test_detect_cli_int8_static_matches_jax(models, monkeypatch):
    """--quant int8 calibrates on the input batch, then detects: the JAX
    CLI's lines, once the port runs the JAX package's fp weights on its
    W-packed convs."""
    names = _jax_packed_convs(*models["yolo"], 64)
    assert len(names) == 8
    load = tools._load_engine

    def same_network(args):
        eng = load(args)
        fp = Engine(EngineConfig(device="cpu")).load_model(args.param,
                                                           args.bin)
        for n in names:
            eng.program.weights[n]["weight"] = fp.program.weights[n]["weight"]
        eng._device_weights = eng.place_weights(eng.program.weights,
                                                eng.program)
        return eng

    monkeypatch.setattr(tools, "_load_engine", same_network)
    args = ["detect", *models["yolo"], *models["images"], "--size", "64",
            "--dtype", "float32", "--quant", "int8"]
    got = _run(tools.main, args + ["--device", "cpu"])
    assert got == _run(jmain, args)
    assert got.count("detections") == 3


def test_classify_cli_int8_static_matches_jax(models):
    args = ["classify", *models["resnet"], *models["images"], "--size",
            "64", "--dtype", "float32", "--quant", "int8", "--topk", "3"]
    got = _run(tools.main, args + ["--device", "cpu"])
    assert got == _run(jmain, args)
    assert got.count("class ") == 9


def test_calibrate_cli_matches_jax(tmp_path):
    """`calibrate` on the same sample files: the same op names and
    scales within rtol 1e-4 (fp32 sums in another order). At an odd
    width the JAX package's stem takes no W-packed path, so both
    packages quantize every conv."""
    model = _save(build_resnet18(batch=1, image_size=65, num_classes=10,
                                 width=8)[0], tmp_path, "r65")
    sample = str(tmp_path / "s.npz")
    x = np.random.default_rng(5).standard_normal(
        (2, 65, 65, 3)).astype(np.float32) / 3
    with open(sample, "wb") as f:
        np.savez(f, **{"0": x})
    out_j, out_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    _run(jmain, ["calibrate", *model, sample, "-o", out_j, "--dtype",
                 "float32"])
    text = _run(tools.main, ["calibrate", *model, sample, "-o", out_t,
                             "--dtype", "float32", "--device", "cpu"])
    assert text.startswith("calibrated ")
    with np.load(out_j) as j, np.load(out_t) as t:
        assert sorted(j.files) == sorted(t.files) and len(j.files) > 10
        for k in j.files:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=0)


def test_device_defaults_to_cuda_and_raises_without_a_card(models):
    """Every model command runs on the card unless --device says
    otherwise; without a card they raise, nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run")
    for argv in (["serve", *models["resnet"], "--port", "0"],
                 ["detect", *models["yolo"], models["images"][0],
                  "--size", "64"],
                 ["classify", *models["resnet"], models["images"][0]],
                 ["segment", *models["unet"], models["images"][0]],
                 ["roofline", *models["yolo"]],
                 ["profile", *models["yolo"]],
                 ["export", *models["yolo"], "-o", "x.pt2"]):
        with pytest.raises(RuntimeError, match="cuda"):
            tools.main(argv)


def test_roofline_cli_matches_jax(models):
    """`roofline --device cpu` prints the JAX CLI's op count and GFLOP a
    batch (the speed-of-light differs: the port's spec is the H100's)."""
    args = ["roofline", *models["yolo"], "--batch", "8", "--top", "5"]
    got = _run(tools.main, args + ["--device", "cpu"]).splitlines()
    want = _run(jmain, args).splitlines()
    assert got[0].split(",")[:2] == want[0].split(",")[:2]
    assert "GFLOP/batch8" in got[0] and "h100" in got[0]
    assert len(got) == len(want) == 7


def test_profile_cli_on_the_cpu(models, tmp_path):
    """`profile --device cpu --quant int8` calibrates on its batch and
    prints the ops by self time (CPU ops: no card) with the model's
    GFLOP a forward, and writes its Chrome trace."""
    out = _run(tools.main, ["profile", *models["yolo"], "--device", "cpu",
                            "--quant", "int8", "--iters", "2", "--top", "5",
                            "--logdir", str(tmp_path / "tr")])
    assert "ms/iter (2 iters)" in out and "cpu" in out
    assert "GFLOP a forward" in out
    assert os.path.exists(tmp_path / "tr" / "trace.json")


def test_export_cli_on_the_cpu(models, tmp_path):
    """`export --device cpu` writes an artifact that load_exported runs
    like the engine the command built."""
    from simpleinfer_tpu_torch import load_exported

    path = str(tmp_path / "y.pt2")
    out = _run(tools.main, ["export", *models["yolo"], "--device", "cpu",
                            "--dtype", "float32", "--batch", "2", "-o",
                            path])
    assert out.strip() == f"wrote {path}"
    eng = Engine(EngineConfig(device="cpu", compute_dtype="float32")
                 ).load_model(*models["yolo"])
    x = RNG.standard_normal((2, 64, 64, 3)).astype(np.float32) / 4
    i, o = eng.input_names[0], eng.output_names[0]
    np.testing.assert_allclose(load_exported(path)({i: x})[o],
                               eng.run({i: x})[o], atol=1e-5, rtol=1e-5)


def test_serve_subprocess_smoke(models):
    """`python -m simpleinfer_tpu_torch serve ... --device cpu --port 0`
    answers /healthz and /v1/infer, prints its kept buckets after
    --warmup --probe-spill, and shuts down on SIGINT."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "simpleinfer_tpu_torch", "serve",
         *models["resnet"], "--port", "0", "--device", "cpu", "--dtype",
         "float32", "--max-batch", "4", "--warmup", "--probe-spill"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    watchdog = threading.Timer(240, proc.kill)   # a silent hang fails
    watchdog.start()
    try:
        lines = []
        while not lines or not lines[-1].startswith("serving "):
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-2000:]
            lines.append(line.strip())
        assert "spill-probed buckets: [1, 2, 4]" in lines
        url = lines[-1].split(" on ")[1].split()[0]
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        x = np.random.default_rng(0).standard_normal(
            (64, 64, 3)).astype(np.float32)
        req = urllib.request.Request(
            url + "/v1/infer", data=json.dumps({"input": x.tolist()})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["shape"] == [10]
        eng = Engine(EngineConfig(device="cpu")).load_model(
            *models["resnet"])
        want = eng.run({eng.input_names[0]: x[None]})[
            eng.output_names[0]][0]
        np.testing.assert_allclose(out["output"], want, atol=1e-4,
                                   rtol=1e-4)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
        assert "shutting down" in proc.stdout.read()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


# ---- serve --generate -------------------------------------------------------
@pytest.fixture(scope="module")
def llama_model(tmp_path_factory):
    from simpleinfer_tpu_torch.zoo import build_llama

    d = tmp_path_factory.mktemp("lm")
    return _save(build_llama("nano", seq_len=32, vocab_size=64)[0], d, "l")


@pytest.mark.parametrize("flags,err", [
    (["--sample-cap", "lots"], "--sample-cap: expected an int"),
    (["--sample-cap", "AUTO", "--kv-prefix-ladder", "128;256"],
     "--kv-prefix-ladder: expected comma-separated ints"),
    (["--prefill-ladder", "64;x"], "--prefill-ladder: expected"),
    (["--tiers", "8-512"], "--tiers: expected slots:window pairs"),
    (["--tiers", "8:512,4:huge"], "--tiers: expected slots:window pairs"),
], ids=["cap", "auto_then_ladder", "prefill", "tiers", "tier_window"])
def test_serve_generate_flag_errors_match_jax(llama_model, flags, err):
    """Bad --generate flags end both CLIs with the same error text
    (SystemExit) before anything is served; 'AUTO' passes --sample-cap
    in both (case-insensitive)."""
    argv = ["serve", *llama_model, "--generate", "--port", "0",
            "--dtype", "float32", *flags]
    with pytest.raises(SystemExit) as want:
        jmain(argv)
    with pytest.raises(SystemExit) as got:
        tools.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert err in str(got.value)


def test_serve_generate_flags_normalized(llama_model):
    """The flags reach the service: 'AUTO' / 'off' keywords in any case,
    comma-separated ladders, slots:window tiers ('FULL' = the model's
    window), the port's --decode-attn names."""
    from simpleinfer_tpu_torch.serving import (GenerationService,
                                               TieredGenerationService)

    eng = Engine(EngineConfig(device="cpu")).load_model(*llama_model)

    def build(*flags):
        ap_args = ["serve", *llama_model, "--generate", "--device", "cpu",
                   *flags]
        parsed = {}
        real = tools.cmd_serve
        try:
            tools.cmd_serve = lambda a: parsed.setdefault("a", a) and 0
            tools.main(ap_args)
        finally:
            tools.cmd_serve = real
        return tools.generation_service(parsed["a"], eng)

    svc = build("--sample-cap", "AUTO", "--kv-prefix-ladder", "8,16",
                "--prefill-ladder", "OFF", "--max-batch", "3",
                "--decode-horizon", "4", "--decode-attn", "torch",
                "--kv-dtype", "bfloat16", "--no-pipeline")
    assert isinstance(svc, GenerationService)
    assert (svc._cap_mode, svc._prefix_ladder, svc._prefill_ladder) == \
        ("auto", [8, 16], [32])
    assert (svc._slots, svc._horizon, svc._pipelined, svc._attn_auto) == \
        (3, 4, False, False)
    assert svc._dec._kv_store == torch.bfloat16
    svc = build("--sample-cap", "off", "--tiers", "2:16,2:FULL")
    assert isinstance(svc, TieredGenerationService)
    assert svc.windows == [16, 32]
    assert all(s._cap_mode == "off" for s in svc.services)
    assert build("--sample-cap", "12")._cap == 12
    with pytest.raises(SystemExit):
        build("--decode-attn", "pallas")


def test_serve_generate_subprocess_smoke(llama_model):
    """`python -m simpleinfer_tpu_torch serve <llama> --generate --device
    cpu --port 0 --warmup` answers /v1/generate (JSON and SSE) with a
    greedy decode's ids, and shuts down on SIGINT."""
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    proc = subprocess.Popen(
        [sys.executable, "-m", "simpleinfer_tpu_torch", "serve",
         *llama_model, "--generate", "--port", "0", "--device", "cpu",
         "--dtype", "float32", "--max-batch", "2", "--decode-horizon", "4",
         "--warmup"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    watchdog = threading.Timer(240, proc.kill)   # a silent hang fails
    watchdog.start()
    try:
        line = ""
        while not line.startswith("serving "):
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-2000:]
        url = line.split(" on ")[1].split()[0]
        eng = Engine(EngineConfig(device="cpu")).load_model(*llama_model)
        want = CachedDecoder(eng).generate(np.asarray([[5, 1, 8]]),
                                           steps=6)[0].tolist()
        for stream in (False, True):
            req = urllib.request.Request(
                url + "/v1/generate", data=json.dumps(
                    {"prompt": [5, 1, 8], "max_new": 6, "stream": stream})
                .encode(), headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                if stream:
                    events = [json.loads(x[6:]) for x in
                              r.read().decode().split("\n")
                              if x.startswith("data: ")]
                    out = events[-1]
                    assert [e["token"] for e in events[:-1]] == want[3:]
                else:
                    out = json.loads(r.read())
            assert out["ids"] == want and out["prompt_len"] == 3
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
        assert "shutting down" in proc.stdout.read()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
