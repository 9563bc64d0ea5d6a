"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``. Nothing is
built at import: the first call that needs a kernel builds it, into
``build/`` beside this package (git-ignored), under a name that carries a
hash of the source and flags, so an edited source is never served from a
stale library. ``build_all`` compiles every source at once, one ``nvcc``
each, and reports what ``-Xptxas -v`` said about registers and shared
memory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load_library"]

_PACKAGE = Path(__file__).resolve().parent.parent
_CSRC = _PACKAGE / "csrc"
_BUILD = _PACKAGE / "build"

#: kernel name -> source file in csrc/.
SOURCES = {
    "backward_kernel": "backward_kernel.cu",
    "fused_rollout": "fused_rollout.cu",
}

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc")
    return path


def _target(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / "lib{}_{}.so".format(name, digest)


def _start(name: str):
    """Starts nvcc for one kernel; returns (process, temp path, target)."""
    target = _target(name)
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(".{}.tmp".format(os.getpid()))
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, proc, tmp: Path, target: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed to build {} (exit {}):\n{}".format(
            SOURCES[name], proc.returncode, out))
    os.replace(tmp, target)
    return out


def build_all(force: bool = False) -> dict:
    """Compiles every kernel source concurrently.

    Returns {name: {"seconds": wall seconds of the whole build,
    "ptxas": nvcc's -Xptxas -v report (empty when the library was
    already built and ``force`` is False)}}.
    """
    t0 = time.perf_counter()
    started = {}
    for name in SOURCES:
        if force or not _target(name).exists():
            started[name] = _start(name)
    reports = {name: _finish(name, *job) for name, job in started.items()}
    seconds = time.perf_counter() - t0
    return {name: {"seconds": seconds, "ptxas": reports.get(name, "")}
            for name in SOURCES}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(target))
        _LIBS[name] = lib
    return lib
