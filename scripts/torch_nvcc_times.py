#!/usr/bin/env python3
"""Times ``nvcc`` on each CUDA source of the port, whole and split by dtype.

Run from the root of a checkout on a machine with the CUDA toolkit:

    python3 scripts/torch_nvcc_times.py

It starts one ``nvcc`` per source of ``pddp_tpu_torch/csrc`` at once, with
``ops/_build.py``'s flags, and prints each one's seconds to finish; then
one ``nvcc`` per source and dtype (``-DPDDP_F32_ONLY``,
``-DPDDP_F64_ONLY``, the libraries ``ops/_build.py`` builds), all at once.
The libraries go to ``build/`` (git-ignored) as ``nvcc_times_*.so``.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(jobs):
    """{label: [seconds to finish, exit code]} of nvcc jobs started at
    once, each (label, source, extra flags)."""
    from pddp_tpu_torch.ops import _build
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for label, src, extra in jobs:
        out = os.path.join(ROOT, "build", "nvcc_times_{}.so".format(label))
        procs[label] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, *extra, "-o", out,
             str(_build._CSRC / src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    done = {}
    while len(done) < len(procs):
        for label, p in procs.items():
            if label not in done and p.poll() is not None:
                done[label] = [round(time.perf_counter() - t0, 2),
                               p.returncode]
        time.sleep(0.2)
    return done


def main():
    from pddp_tpu_torch.ops import _build
    print(json.dumps({"whole": run([(n, s, []) for n, s in
                                    _build.SOURCES.items()])}), flush=True)
    print(json.dumps({"split": run([
        (n + "_" + d, s, [flag]) for n, s in _build.SOURCES.items()
        for d, flag in _build.DTYPES.items()])}), flush=True)
    print(json.dumps({"cpu_count": os.cpu_count()}))


if __name__ == "__main__":
    main()
