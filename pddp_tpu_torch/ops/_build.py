"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` (with the shared headers ``csrc/*.cuh`` it
includes) is compiled by ``nvcc`` into two shared libraries with a plain C
interface, loaded with ``ctypes``: one of its float32 entries and one of
its float64 entries (``-DPDDP_F32_ONLY``, ``-DPDDP_F64_ONLY``), so that
the halves compile side by side (``scripts/torch_nvcc_times.py`` times
both ways: on the H100's host the whole ``backward_kernel.cu`` took 124
s, its halves 59 and 70 s at once).
Nothing is built at import: the first call that needs a kernel builds its
library, into ``build/`` beside this package (git-ignored), under a name
that carries a hash of the source and flags, so an edited source is never
served from a stale library. ``build_all`` compiles every library at
once, one ``nvcc`` each, and reports what ``-Xptxas -v`` said about
registers and shared memory.
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
    "fused_bnn_rollout": "fused_bnn_rollout.cu",
    "fused_particle_rollout": "fused_particle_rollout.cu",
}

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: a library's entries -> the flag that keeps only them.
DTYPES = {"f32": "-DPDDP_F32_ONLY", "f64": "-DPDDP_F64_ONLY"}

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc")
    return path


def _flags(dtype: str) -> tuple:
    return _FLAGS + (DTYPES[dtype],)


def _target(name: str, dtype: str) -> Path:
    """The library's path: the hash covers the source, every shared header
    in csrc/ and the flags."""
    src = (_CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(dtype)).encode()
                            ).hexdigest()[:16]
    return _BUILD / "lib{}_{}_{}.so".format(name, dtype, digest)


def _start(name: str, dtype: str):
    """Starts nvcc for one library; returns (process, temp path,
    target)."""
    target = _target(name, dtype)
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(".{}.tmp".format(os.getpid()))
    cmd = [_nvcc(), *_flags(dtype), "-o", str(tmp),
           str(_CSRC / SOURCES[name])]
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
    """Compiles every library (each source's two) concurrently.

    Returns {name: {"seconds": wall seconds of the whole build,
    "ptxas": nvcc's -Xptxas -v report of both libraries (empty when they
    were already built and ``force`` is False)}}.
    """
    t0 = time.perf_counter()
    started = {}
    for name in SOURCES:
        for dtype in DTYPES:
            if force or not _target(name, dtype).exists():
                started[name, dtype] = _start(name, dtype)
    reports = {key: _finish(key[0], *job) for key, job in started.items()}
    seconds = time.perf_counter() - t0
    return {name: {"seconds": seconds,
                   "ptxas": "".join(reports.get((name, d), "")
                                    for d in DTYPES)}
            for name in SOURCES}


def load_library(name: str, dtype) -> ctypes.CDLL:
    """The loaded library of kernel ``name``'s entries of ``dtype``
    (``torch.float32`` or ``torch.float64``), built on first use."""
    key = (name, {"torch.float32": "f32", "torch.float64": "f64"}[
        str(dtype)])
    lib = _LIBS.get(key)
    if lib is None:
        target = _target(*key)
        if not target.exists():
            _finish(name, *_start(*key))
        lib = ctypes.CDLL(str(target))
        _LIBS[key] = lib
    return lib
