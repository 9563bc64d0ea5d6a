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

K2(f)'s and K2(g)'s libraries are generated: ``ops/traced_rollout.py``
prints a source from a trace, and ``build_all`` and ``load_library`` take
its text in place of a file of ``csrc/``: it is written under
``build/gen/`` and compiled with the same flags and ``--fmad=false``
(``-I csrc`` finds ``csrc/traced_rollout.cuh``), one library a dtype,
named by a hash of the text, the shared headers and the flags. So are
those of K2(e) over a traced inner step (``ops/fused_particle_rollout.py``,
around ``csrc/fused_particle_rollout.cuh``), but with contraction on
(``contract=True``): the hand-written kernel builds as its
``csrc/`` instances do, and the traced step's products go through
``pddp_tr::mul_``, which no compiler contracts.
"""

from __future__ import annotations

import concurrent.futures
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


#: what a generated source adds to the flags: no contraction of a
#: multiply and an add into an FMA, so that the traced arithmetic rounds
#: after every operation as torch's does.
_GENERATED_FLAGS = ("--fmad=false",)

_DTYPE_NAMES = {"torch.float32": "f32", "torch.float64": "f64"}


def _flags(dtype: str, generated: bool = False,
           contract: bool = False) -> tuple:
    return _FLAGS + (DTYPES[dtype],) + (
        _GENERATED_FLAGS if generated and not contract else ())


def _target(name: str, dtype: str, text: str = None,
            contract: bool = False) -> Path:
    """The library's path: the hash covers the source (``csrc/``'s file
    of kernel ``name``, or the generated ``text``), every shared header in
    csrc/ and the flags."""
    src = ((_CSRC / SOURCES[name]).read_bytes() if text is None
           else text.encode())
    src += b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    flags = _flags(dtype, text is not None, contract)
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return _BUILD / "lib{}_{}_{}.so".format(name, dtype, digest)


def _start(name: str, dtype: str, text: str = None, contract: bool = False):
    """Starts nvcc for one library (a generated ``text`` is written under
    build/gen/ first); returns (source, process, temp path, target)."""
    target = _target(name, dtype, text, contract)
    _BUILD.mkdir(parents=True, exist_ok=True)
    if text is None:
        source = _CSRC / SOURCES[name]
    else:
        source = _BUILD / "gen" / (target.stem[3:] + ".cu")
        source.parent.mkdir(exist_ok=True)
        source.write_text(text)
    tmp = target.with_suffix(".{}.tmp".format(os.getpid()))
    cmd = [_nvcc(), *_flags(dtype, text is not None, contract), "-I",
           str(_CSRC),
           "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return source, proc, tmp, target


def _finish(source, proc, tmp: Path, target: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed to build {} (exit {}):\n{}".format(
            source, proc.returncode, out))
    os.replace(tmp, target)
    return out


def build_all(force: bool = False, generated=()) -> dict:
    """Compiles every library concurrently, one ``nvcc`` each: each csrc/
    source's two and, from ``generated``, a list of (name, text, dtype)
    or (name, text, dtype, contract) (dtype a torch dtype; contract as
    ``load_library``'s), each generated source's.

    Returns {name: {"seconds": wall seconds from the start to the end of
    its last library, "ptxas": nvcc's -Xptxas -v report of its libraries
    (empty where they were already built and ``force`` is False)}};
    raises on the first failed build.
    """
    t0 = time.perf_counter()
    jobs = [(name, d, None, False) for name in SOURCES for d in DTYPES]
    jobs += [(job[0], _DTYPE_NAMES[str(job[2])], job[1],
              bool(job[3]) if len(job) > 3 else False) for job in generated]
    started = {}
    for name, d, text, contract in jobs:
        if (name, d) not in started and (
                force or not _target(name, d, text, contract).exists()):
            started[name, d] = _start(name, d, text, contract)

    def wait(job):
        out = _finish(*job)
        return out, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(max(1, len(started))) as pool:
        done = dict(zip(started, pool.map(wait, started.values())))
    report = {job[0]: {"seconds": 0.0, "ptxas": ""} for job in jobs}
    for (name, _), (out, seconds) in done.items():
        report[name]["seconds"] = max(report[name]["seconds"], seconds)
        report[name]["ptxas"] += out
    return report


def load_library(name: str, dtype, text: str = None,
                 contract: bool = False) -> ctypes.CDLL:
    """The loaded library of ``name``'s entries of ``dtype``
    (``torch.float32`` or ``torch.float64``): csrc/'s kernel ``name`` or,
    given its ``text``, a generated source (without ``--fmad=false``
    where ``contract``); built on first use (raises with nvcc's output
    where the build fails)."""
    key = (name, _DTYPE_NAMES[str(dtype)], text, contract)
    lib = _LIBS.get(key)
    if lib is None:
        target = _target(*key)
        if not target.exists():
            _finish(*_start(*key))
        lib = ctypes.CDLL(str(target))
        _LIBS[key] = lib
    return lib
