#!/usr/bin/env python3
"""Where a step of K2(e), the particle line search, spends its cycles.

    python3 scripts/torch_k2e_stamps.py [--rows ROW,...]

Run from the root of a checkout on a machine with a CUDA card. It writes
a development copy of ``pddp_tpu_torch/csrc/fused_particle_rollout.cu``
under ``build/k2e_stamps/`` (git-ignored) in which thread 0 of every
block reads ``clock64()`` at ten points of each step and sums the
intervals in registers, block 0 adding them to a ``__device__`` array at
its end; builds its float32 entries with ``nvcc`` (the flags of
``ops/_build.py``); and, for each of ``chip_smoke.py``'s phase-19a rows
(``PARTICLE_ROWS``: P=100, N=50, ten alphas, one solve; the local model
of U0 and the plain backward's gains at the first reg of
``PARTICLE_K1_REGS`` that keeps them finite), launches it three times
and prints the last launch's cycles a step in each interval:

  0 the loop's top; 1 the noise solve and its fallback's OR;
  2 AUX, X and the example's step; 3 the mean's butterfly and barrier;
  4 the mean's sum over the warps; 5 the second moments' butterfly and
  barrier (with the ring's refill); 6 the belief warp's sums (matrix
  codecs); 7 the ladder or the diagonal codec's roots; 8 the Z row and
  the next feedback law; 9 the step's last barrier.

Thread 0 is in the belief warp, so intervals 6-8 are its work and the
others include its waits. The stamps add a few cycles each; the line
also gives the stamped kernel's time (CUDA events, 50 launches) for
comparison with the library's. One JSON line a row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "k2e_stamps")
SRC = os.path.join(ROOT, "pddp_tpu_torch", "csrc")

# (anchor in the kernel's source, stamp inserted before it)
ANCHORS = (
    ("    // The step's noise: eps Uc = prev - mean", 0),
    ("    if (active) store_row<n>(AUX", 1),
    ("    // The moment match: the mean ...", 2),
    ("    T mine = T(0);  // lane j < n: mean j", 3),
    ("    // ... then the second moments about it", 4),
    ("    // The belief warp: z of step i+1", 5),
    ("        // CHOL: the encode's factor is the next step's", 6),
    ("      T* row = Z_out + (size_t(i + 1) * A + a) * nz;", 7),
)
LOOP_END = "    __syncthreads();\n  }\n}\n"


def stamped_source():
    """The kernel's source with the stamps."""
    src = open(os.path.join(SRC, "fused_particle_rollout.cu")).read()
    src = src.replace("namespace {\n", (
        "__device__ unsigned long long g_stamps[10];\n"
        "#define STAMP(k) if (threadIdx.x == 0) { const long long t_ = "
        "clock64(); acc_[k] += t_ - t_prev; t_prev = t_; }\n"
        "namespace {\n"), 1)
    start = "  const T alpha = g.alphas[a];\n"
    assert src.count(start) == 1
    src = src.replace(start, start + "  long long t_prev = clock64();\n"
                      "  long long acc_[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n")
    for anchor, k in ANCHORS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, "    STAMP({});\n".format(k) + anchor)
    assert src.count(LOOP_END) == 1
    src = src.replace(LOOP_END, (
        "    STAMP(8);\n    __syncthreads();\n    STAMP(9);\n  }\n"
        "  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
        "    for (int k_ = 0; k_ < 10; ++k_) g_stamps[k_] += acc_[k_];\n"
        "}\n"))
    return src + (
        '\nextern "C" int k2e_stamps(unsigned long long* out) {\n'
        "  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamps, "
        "sizeof(g_stamps));\n"
        "  unsigned long long z[10] = {0};\n"
        "  cudaMemcpyToSymbol(g_stamps, z, sizeof(z));\n"
        "  return int(e);\n}\n")


def build():
    from pddp_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    for h in ("async_copy.cuh", "belief_codec.cuh", "examples.cuh"):
        with open(os.path.join(SRC, h)) as f, \
                open(os.path.join(OUT, h), "w") as g:
            g.write(f.read())
    cu = os.path.join(OUT, "k2e_stamps.cu")
    with open(cu, "w") as f:
        f.write(stamped_source())
    lib = os.path.join(OUT, "libk2e_stamps.so")
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-DPDDP_F32_ONLY", "-o",
                    lib, cu], check=True, capture_output=True)
    return ctypes.CDLL(lib)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", help="phase-19a rows, comma-separated "
                    "(default: all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_k2e_stamps: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pddp_tpu_torch.controllers.ilqr import (backward,
                                                 default_fit_alphas,
                                                 local_model, rollout)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops._examples import (MODELS, example_of,
                                              param_buffer)
    print(cs.card_line(), flush=True)
    lib = build()
    fn = lib.pddp_particle_rollout_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    stamps = (ctypes.c_ulonglong * 10)()
    want = set(args.rows.split(",")) if args.rows else None
    f32 = torch.float32
    for label, _, codec, _ in cs.PARTICLE_ROWS:
        if want is not None and label not in want:
            continue
        enc = StateEncoding[codec]
        model, cost, z0, U0 = cs.particle_problem(label, "cuda", f32)
        Z, AUX = rollout(model, z0, U0, enc)
        derivs = local_model(Z, U0, AUX, model, cost, enc)
        for reg in cs.PARTICLE_K1_REGS:
            k, K, ok = backward(*derivs, reg=reg)
            if bool(ok):
                break
        ins = [t[None].contiguous() for t in (derivs[0], U0, k, K)]
        B, N, A = 1, U0.shape[0], 10
        alphas = default_fit_alphas(f32, "cuda")
        base, constrained = example_of(model.inner)
        params = param_buffer(model.inner, None, f32, "cuda")
        eps = model.eps.contiguous()
        nz, nu = ins[0].shape[-1], U0.shape[-1]
        n, P = model.state_size, model.n_particles
        outs = [torch.empty(s, device="cuda") for s in (
            (B, N + 1, A, nz), (B, N, A, nu), (B, N, A, P, n))]
        call = ([t.data_ptr() for t in ins + [alphas, params, eps]] + [None]
                + [o.data_ptr() for o in outs]
                + [B, N, A, P, MODELS[base], int(enc), int(constrained), 1,
                   torch.cuda.current_stream().cuda_stream])
        for _ in range(3):
            lib.k2e_stamps(stamps)
            if fn(*call) != 0:
                raise RuntimeError("stamped K2(e) launch failed")
            torch.cuda.synchronize()
        lib.k2e_stamps(stamps)
        cycles = [round(stamps[i] / N) for i in range(10)]
        print(json.dumps({"row": label, "N": N, "cycles_a_step": cycles,
                          "total": sum(cycles),
                          "stamped_ms": cs.events_ms(lambda: fn(*call), 50)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
