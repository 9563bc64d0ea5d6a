#!/usr/bin/env python3
"""``chip_smoke.py`` phase 22 (K2(g) and K2(e) over a traced inner step)
alone, with the builds it needs.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 scripts/torch_k2g_phase.py

It traces the rows of phases 21 and 22 (``tests/traced_models.py``) and
runs the CPU's float64 solve of G1 beside the build of the hand-written
kernels (``_build.build_all``), builds the traced libraries after it,
then runs phase 22 (22a-22e), each part's JSON line as ``chip_smoke.py``
prints it, and the kernels line's phase-22 rows. It exits non-zero on
any failure, and without a card.
"""

import concurrent.futures
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.card_line()
    print(card, flush=True)
    from pddp_tpu_torch.ops import _build
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cpu = pool.submit(cs.stateful_cpu_solve)
        built = threading.Event()
        build = pool.submit(cs.traced_builds, built)
        try:
            _build.build_all()
        finally:
            built.set()
        build = build.result()
        cpu = cpu.result()
    cs.emit({"build_s": time.perf_counter() - t0})
    stateful = cs.phase22_stateful(card, build, cpu)
    cs.emit({"kernels": cs.stateful_kernel_rows(stateful)})
    cs.emit({"total_s": time.perf_counter() - t0})
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
