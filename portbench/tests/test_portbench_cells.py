"""CPU rehearsals of each cell at a tiny size, the result line's keys,
the refusal without a card, and the faults `correct` has to catch: a
run whose timed path is broken underneath reads `correct` false.

The card's tests (`-m cuda`) run each cell's controls at its own size;
here they skip.
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

TINY = {
    "yolo": ("yolov5s-640-int8w.b32-offline",
             {"config": {"width_multiple": 0.25, "image_size": 64},
              "traffic": {"batch": 2, "check_within": 2, "check_batches": 1,
                          "warmup_batches": 1}}),
    "yolo128": ("yolov5s-640-int8w.b128-offline",
                {"config": {"width_multiple": 0.25, "image_size": 64},
                 "traffic": {"batch": 4, "check_within": 2,
                             "check_batches": 1, "warmup_batches": 1}}),
    "gpt": ("gpt2-small-int4w.score-1k",
            {"config": {"n_positions": 64, "n_embd": 128, "n_head": 4,
                        "n_layer": 2, "vocab_size": 256},
             "traffic": {"slots": 4, "clients": 8, "prompt_min": 20,
                         "prompt_max": 40, "bucket": 64,
                         "warmup_completions": 8,
                         "check_requests": 8}}),
}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def rehearse(kind, trace=False, seconds=0.6, seed=2 ** 31 + 11, **kw):
    cell, over = TINY[kind]
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            overrides=over, **kw)


@pytest.mark.parametrize("kind", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(kind, trace):
    run, result = rehearse(kind, trace)
    assert result["correct"], result["checks"]
    keys = list(result)
    assert keys[-1] == "checks"
    assert keys[:5] == KEYS
    assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
    manifest = harness.load_manifest()
    want = {m["name"] for m in harness.metrics_for(manifest, run.workload,
                                                   trace)}
    got = set(result["metrics"])
    if trace:
        # no device here: the readers of the device's kernels read nothing
        assert got <= want and got
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 5])
def test_seed_fixes_weights_and_traffic(seed):
    from simpleinfer_tpu_torch import zoo

    from portbench import weights
    from portbench.drivers import closed_loop_generate as gen

    def made(s):
        graph = zoo.build_gpt("nano", seq_len=16, vocab_size=64)[0]
        return [m[3] for m in weights.fill_graph(graph, s, "cpu")]

    a, b, c = made(seed), made(seed), made(seed + 1)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not all((x == y).all() for x, y in zip(a, c))
    cell, over = TINY["gpt"]
    _, _, config, traffic = harness.cell_spec(harness.load_manifest(), cell)
    run = harness.Run(cell, {**config, **over["config"]},
                      {**traffic, **over["traffic"]}, seed, 1.0, False,
                      "cpu", 0.0)
    p, q = gen._Clients(run, None), gen._Clients(run, None)
    assert all((p.prompt(j) == q.prompt(j)).all() for j in range(50))
    lens = sorted(len(p.prompt(j)) for j in range(len(p.lens)))
    run.seed += 1
    assert lens == sorted(len(gen._Clients(run, None).prompt(j))
                          for j in range(len(p.lens)))


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gpt2-small-int4w.score-1k", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/ (no
    program) fails and prints no result."""
    import shutil

    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "yolov5s-640-int8w.b32-offline", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


# ------------------------------------------------------------------ faults


@pytest.mark.parametrize("fault", ["rows altered", "head altered",
                                   "half the batch left out"])
def test_yolo_faults_fail(fault, monkeypatch):
    from simpleinfer_tpu_torch import engine
    from simpleinfer_tpu_torch.zoo import detect

    decode, forward = detect.decode_device, engine.Engine.forward

    def bad_decode(*a, **k):
        return decode(*a, **k) + torch.tensor([1.0, 0, 0, 0, 0, 0])

    def bad_forward(self):
        staged = dict(self._staged)
        if fault == "half the batch left out":
            for k, x in staged.items():
                half = x[: x.shape[0] // 2]
                self._staged[k] = torch.cat([half, half])
        forward(self)
        self._staged = staged
        if fault == "head altered":
            for k, y in self._outputs.items():
                y = y.clone()
                y[..., 4] += 0.1
                self._outputs[k] = y

    if fault == "rows altered":
        monkeypatch.setattr(detect, "decode_device", bad_decode)
    else:
        monkeypatch.setattr(engine.Engine, "forward", bad_forward)
    result = rehearse("yolo")[1]
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["token altered",
                                   "half the wave left out"])
def test_gpt_faults_fail(fault, monkeypatch):
    from simpleinfer_tpu_torch.zoo import generate

    prefill = generate.CachedDecoder.prefill_sample
    vocab = TINY["gpt"][1]["config"]["vocab_size"]

    def bad_prefill(self, *a, **k):
        tok, caches = prefill(self, *a, **k)
        if fault == "token altered":
            return (tok + 1) % vocab, caches
        half = tok.shape[0] // 2          # the wave's second half left out
        if half:
            tok = tok.clone()
            tok[half:] = tok[0]
        return tok, caches

    monkeypatch.setattr(generate.CachedDecoder, "prefill_sample",
                        bad_prefill)
    result = rehearse("gpt")[1]
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gpt2-small-int4w.score-1k",
                                  "yolov5s-640-int8w.b128-offline"])
def test_controls_fail_on_the_card(cell):
    """The control of each configuration, at the cell's own size on three
    seeds, reads above the configuration's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/controls.py", "--workload", cell,
         "--seeds", "101", "102", "103"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=1800)
    assert out.returncode == 0, out.stderr[-2000:]
    config = harness.cell_spec(harness.load_manifest(), cell)[2]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        if "logit_gap.fp8_reference" in r:
            assert r["logit_gap.fp8_reference"] > \
                config["limits"]["logit_gap"]
        else:
            assert r["head_gap.fp8_reference"] > \
                config["limits"]["head_gap"]
