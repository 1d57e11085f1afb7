"""The harness: finds a cell's files by name, runs its driver, reads the
metrics and prints the result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
and a traffic mix. The configuration's file holds its sizes; the
traffic file names its driver (`drivers/<driver>.py`, one general
generator per kind of traffic) and the driver's parameters. Each
per-layer metric is `metrics/<name>.py`, whose `read(ctx)` returns a
number or None. Nothing here is specific to one cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

#: top-level module names that must not be loaded by the end of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "simpleinfer_tpu")


def log(run, msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"portbench [{time.perf_counter() - run.t_start:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


class CellError(RuntimeError):
    """The cell cannot run here (no card, a file missing)."""


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(manifest: dict, workload: str) -> tuple:
    """(workload entry, config entry, config dict, traffic dict)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in {MANIFEST.name}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    centry = configs[cell["config"]]
    with open(ROOT / centry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, centry, config, traffic


def metrics_for(manifest: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports."""
    group = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run must not load,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every cache a library may write goes to a fixed directory inside
    the checkout (the port's kernels build into its own `_build/`)."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("TEARDOWN_CUPTI", "0")


@dataclass
class Run:
    """What a driver is given, and what it hands back."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    # filled by the driver
    setup_s: float = 0.0
    end_to_end: dict = field(default_factory=dict)
    ctx: dict = field(default_factory=dict)       # what metric readers read
    checks: dict = field(default_factory=dict)    # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
    forbidden: list = field(default_factory=list)

    def window_opens(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def window_closed(self) -> None:
        """Read what must be read before the reference runs: the memory
        peak, and which forbidden modules the run has loaded."""
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        self.forbidden = forbidden_modules()

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v is not None and v <= lim for v, lim in self.checks.values())


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", manifest: dict | None = None,
             overrides: dict | None = None,
             t_start: float | None = None) -> tuple:
    """Run one cell; returns (Run, result dict). `overrides` updates the
    configuration and traffic dicts (the CPU rehearsals shrink them)."""
    manifest = manifest or load_manifest()
    cell, _, config, traffic = cell_spec(manifest, workload)
    config = {**config, **(overrides or {}).get("config", {})}
    traffic = {**traffic, **(overrides or {}).get("traffic", {})}
    run = Run(workload, config, traffic, int(seed), float(seconds), trace,
              device, t_start if t_start is not None else time.perf_counter())
    load_driver(traffic["driver"]).run(run)
    metrics = {}
    for m in metrics_for(manifest, workload, trace):
        if trace:
            value = load_reader(m["name"])(run.ctx)
        else:
            value = run.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": _device_kind(device), "count": cell["chips"],
           "memory_peak_bytes": run.memory_peak_bytes}
    if trace:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.window_s
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.breakdown is not None:
        result["breakdown"] = run.breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.checks.items()}
    return run, result


def _device_kind(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    import torch

    return torch.cuda.get_device_name()
