"""BENCHMARK.json and every file it names by name load, and keep to the
benchmark's contract; no module of the benchmark imports JAX or the
JAX package, and the references import nothing of the program.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(harness.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_lines():
    named = (MANIFEST["configs"] + MANIFEST["workloads"]
             + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names)), group
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in MANIFEST["workloads"] + MANIFEST["configs"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in MANIFEST["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_configs_files_and_reduced():
    for c in MANIFEST["configs"]:
        path = harness.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        cfg = json.loads(path.read_text())
        assert cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert key in cfg and not key.endswith(("_dim", "_rank"))
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    entry, _, config, traffic = harness.cell_spec(MANIFEST, cell)
    assert entry["chips"] in (1, 4)
    assert harness.load_driver(traffic["driver"]).run
    e2e = {m["name"] for m in harness.metrics_for(MANIFEST, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metrics_for(MANIFEST, cell, True)
    assert per_layer
    for m in per_layer:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in e2e, (m["name"], m["moves"])
    assert "limits" in config


def test_every_metric_listed_cell_exists():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in MANIFEST["per_layer"]:
        moved = next(e for e in MANIFEST["end_to_end"]
                     if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


SOURCES = sorted(p for p in HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not _imports(path) & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("name", ["models.py", "yardstick.py"])
def test_references_take_nothing_of_the_program(name):
    assert "simpleinfer_tpu_torch" not in _imports(HERE / name)
    # nor through a relative import of a harness module that does
    tree = ast.parse((HERE / name).read_text())
    rel = {n.module for n in ast.walk(tree)
           if isinstance(n, ast.ImportFrom) and n.level}
    rel |= {a.name for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.level and not n.module
            for a in n.names}
    assert rel <= {"models", None}, rel
