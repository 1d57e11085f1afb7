"""Rules of the PyTorch/CUDA port (simpleinfer_tpu_torch): it imports
neither jax nor the JAX package, runs without jax installed, and its
entry points run on CUDA unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import pytest
import torch

from simpleinfer_tpu_torch import Engine, EngineConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "simpleinfer_tpu_torch")


def _port_files():
    """The port, chip_smoke.py, its control script and the card's tests,
    which all run where only PyTorch is installed."""
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "torch_onoff_control.py"),
             os.path.join(ROOT, "tests", "test_torch_cuda.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    """jax, jax.*, jaxlib, and the JAX package (simpleinfer_tpu and its
    submodules) — but not simpleinfer_tpu_torch, which shares the
    prefix."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "simpleinfer_tpu"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_forbidden_tells_the_packages_apart():
    assert _forbidden("jax.numpy") and _forbidden("simpleinfer_tpu.ir")
    assert _forbidden("simpleinfer_tpu")
    assert not _forbidden("simpleinfer_tpu_torch.ir")
    assert not _forbidden("torch")


def test_runs_without_jax():
    """With jax made unimportable, the port imports and runs a tiny CPU
    forward, and the JAX package is never loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from simpleinfer_tpu_torch import Engine, EngineConfig\n"
        "from simpleinfer_tpu_torch.zoo import build_yolov5\n"
        "g, i, o = build_yolov5('n', batch=1, image_size=32)\n"
        "e = Engine(EngineConfig(device='cpu', quant='int8w',\n"
        "                        use_kernels=True)).load_model(None, graph=g)\n"
        "out = e.run({i: np.zeros((1, 32, 32, 3), np.float32)})[o]\n"
        "assert out.shape == (1, 63, 85), out.shape\n"
        "assert not any(m == 'simpleinfer_tpu' or\n"
        "               m.startswith('simpleinfer_tpu.') for m in sys.modules)\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")


def test_defaults_to_cuda():
    cfg = EngineConfig()
    assert cfg.device == "cuda"
    assert cfg.torch_device.type == "cuda"
    assert cfg.kernels_enabled  # use_kernels=None: on for CUDA
    assert not EngineConfig(device="cpu").kernels_enabled


def test_cuda_request_without_card_raises(monkeypatch):
    """Asking for CUDA without a card raises; nothing moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine()
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(EngineConfig(device="cuda:0"))
    assert Engine(EngineConfig(device="cpu")).device.type == "cpu"


def test_every_kernel_source_is_built_and_counted():
    """Each csrc/*.cu is in chip_smoke.py's SOURCES (built in its phase
    1), is some kernels/ module's SOURCE, and that module keeps a plain
    integer launch count."""
    import importlib

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    sources = sorted(n for n in os.listdir(os.path.join(PKG, "csrc"))
                     if n.endswith(".cu"))
    assert sorted(chip_smoke.SOURCES) == sources
    owners = {}
    for name in ("matmul", "c3block", "attention", "decode_attn",
                 "conv3x3", "stem"):
        mod = importlib.import_module(f"simpleinfer_tpu_torch.kernels.{name}")
        for key in dir(mod):
            if key.startswith("SOURCE"):
                owners[getattr(mod, key)] = mod
    assert sorted(owners) == sources
    for mod in owners.values():
        assert isinstance(mod.launches, int)


@pytest.mark.parametrize("module", [
    "host.py", "ir/codegen.py", "zoo/detect.py", "zoo/metrics.py",
    "zoo/imageio.py", "zoo/segment.py", "ops/yolo.py", "engine.py"])
def test_new_modules_are_checked(module):
    """The slice's modules are among the files test_no_jax_imports
    reads."""
    assert os.path.join(PKG, module) in _port_files()


def test_host_library_from_the_ports_source_only():
    """host.py builds csrc/si_host.cpp of the port into the port's
    gitignored _build/ and loads nothing of the JAX package's host
    library (csrc/si_host.cpp, csrc/libsi_host.so at the root)."""
    from simpleinfer_tpu_torch import host

    assert host.SOURCE == Path(PKG, "csrc", "si_host.cpp")
    assert host.library_path().parent == Path(PKG, "_build")
    text = open(os.path.join(PKG, "host.py")).read()
    assert "libsi_host.so" not in text and "dirname(os.path" not in text
    # the build lands under .gitignore's entry, never in a commit
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "simpleinfer_tpu_torch/_build/" in ignored
    assert str(host.library_path()).startswith(
        os.path.join(ROOT, "simpleinfer_tpu_torch", "_build") + os.sep)


def test_detect_pipeline_runs_without_jax():
    """With jax made unimportable: a YOLOv8n engine, detect_images with
    the device decode and the native letterbox and NMS; neither the JAX
    package nor its host library is loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from simpleinfer_tpu_torch import Engine, EngineConfig, host\n"
        "from simpleinfer_tpu_torch.zoo import build_yolov8\n"
        "from simpleinfer_tpu_torch.zoo.detect import detect_images\n"
        "g, i, o = build_yolov8('n', batch=1, image_size=32)\n"
        "e = Engine(EngineConfig(device='cpu')).load_model(None, graph=g)\n"
        "img = np.zeros((40, 50, 3), np.uint8)\n"
        "d = detect_images(e, [img], size=32, device_decode=True)\n"
        "h = detect_images(e, [img], size=32)\n"
        "assert len(d) == len(h) == 1\n"
        "assert host.available()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'csrc/libsi_host.so' not in maps\n"
        "assert 'libsi_host_' in maps\n"
        "assert not any(m == 'simpleinfer_tpu' or\n"
        "               m.startswith('simpleinfer_tpu.') for m in sys.modules)\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")
