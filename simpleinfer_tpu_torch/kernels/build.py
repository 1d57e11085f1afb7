"""Build and bind the port's CUDA sources (csrc/*.cu).

Each source is one shared library with a plain C interface: nvcc builds
it for sm_90a (no PyTorch headers, so a build takes seconds) into
`_build/` beside the package, under a name that carries a hash of the
source and the flags, and ctypes binds it. `build` starts one nvcc per
source, all together, and waits for them; `load` builds one source if
its library is missing and binds it once per process.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source file name -> {library, seconds, built, ptxas} of the last build
build_info: dict = {}
_libs: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(source: str) -> Path:
    """Where the library of csrc/`source` lives for these flags (the
    hash covers the shared headers too)."""
    src = (CSRC / source).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}_{tag[:16]}.so"


def build(sources, rebuild: bool = False) -> dict:
    """Build csrc/`sources` with one nvcc each, started together; skips
    a source whose library exists unless `rebuild`. Raises with nvcc's
    output when a build fails. Returns build_info for `sources`."""
    jobs = []
    t0 = time.perf_counter()
    for source in sources:
        so = library_path(source)
        if so.exists() and not rebuild:
            build_info[source] = dict(library=str(so), seconds=0.0,
                                      built=False, ptxas="")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((source, so, tmp, proc))
    failures = []
    for source, so, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed to build {source} (exit "
                            f"{proc.returncode}):\n{out}\n{err}")
            continue
        os.replace(tmp, so)
        build_info[source] = dict(library=str(so), built=True, ptxas=err,
                                  seconds=time.perf_counter() - t0)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {s: build_info[s] for s in sources}


def load(source: str, bind: Callable, rebuild: bool = False):
    """The ctypes library of csrc/`source`, built if missing (or when
    `rebuild`), with `bind(lib)` setting its argtypes; once per
    process."""
    lib = _libs.get(source)
    if lib is not None and not rebuild:
        return lib
    so = library_path(source)
    if rebuild or not so.exists():
        build([source], rebuild=True)
    lib = ctypes.CDLL(str(so))
    bind(lib)
    _libs[source] = lib
    return lib
