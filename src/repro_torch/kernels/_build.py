"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/lib<name>.so`` at the repository root, compiled for ``sm_90a``;
the Hopper helpers the sources share are in ``csrc/hopper.cuh``, and an
edited header rebuilds every library.  Nothing is built at import: the
first wrapper call builds its library (about seconds per source), and
:func:`build_all` builds every source at once with one nvcc process each.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the hand kernels build only "
                           "where the CUDA toolkit is installed")
    return str(path)


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Whether lib<name>.so is missing or older than its source or any of
    the shared headers (``csrc/*.cuh``) the sources include."""
    so = _target(name)
    if not so.exists():
        return True
    inputs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return so.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, _target(name))
    return log


def build_all() -> dict[str, str]:
    """Compile every stale source in parallel; returns nvcc's log per source."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    procs = {n: _start(n) for n in names if _stale(n)}
    return {n: _finish(n, p) for n, p in procs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if it is missing or stale."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
