#!/usr/bin/env python3
"""Same-card A/B of the port's latency-chain kernels, K1 and K2(a)-(c),
between two checkouts of the repository, on one NVIDIA H100.

    python3 scripts/torch_kernel_ab.py --parent DIR [--order change,parent,...]

runs one turn per entry of ``--order`` (default change, parent, parent,
change) in subprocesses, DIR holding the parent's files (e.g. unpacked by
``git archive`` into a git-ignored directory), and prints each turn's JSON
line, then a summary line with the best of each side's turns. One turn,

    python3 scripts/torch_kernel_ab.py --tree DIR --label NAME

imports ``pddp_tpu_torch`` from DIR, builds its kernels there, and times
in float32 with CUDA events after a warm-up:
 * K1 alone at every path's shape (nz, nu) and horizon, for one solve and
   for 64, on seeded inputs (``chip_smoke.k1_inputs``);
 * K2 alone (stages a-c) at every path's model and codec, H=200, ten
   alphas, for one solve and for 64, on nominal rollouts with gains that
   hold the closed loop (``chip_smoke.k2bc_inputs``); and the double
   cartpole's K2 at its first iteration's inputs (the local model of
   U0 = 0.1, gains at reg=0);
 * the host's time per call, on the host clock, of the wrappers
   ``kernel_backward`` and ``fused_control_law`` and of the bare ctypes
   launches inside them, at the main path's shape (200 calls issued
   back to back, then one synchronize);
 * one iteration (local model, K1, K2, argmin; best and median of five
   runs of five) and the 50-iteration solve (two runs, each with its
   evaluations and iterations) through the kernels on the cartpole main
   path and the example paths (the belief-state pendulum's solve takes
   tens of seconds and is left out).
With ``--main-path-only`` a turn times the wrappers' host time and the
cartpole main path alone, for many short turns.
The K1 of a checkout from before the kernels wrote ``ok`` takes no ``ok``
pointer; the script launches either.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CS = None  # this checkout's chip_smoke module, loaded by ``turn``

# label -> (chip_smoke.EXAMPLES name, codec)
PATHS = {"cartpole": ("cartpole", "IGNORE_UNCERTAINTY"),
         "pendulum": ("pendulum", "IGNORE_UNCERTAINTY"),
         "double_cartpole": ("double_cartpole", "IGNORE_UNCERTAINTY"),
         "rendezvous": ("rendezvous", "IGNORE_UNCERTAINTY"),
         "pendulum_chol": ("pendulum", "UPPER_TRIANGULAR_CHOLESKY")}
# K1's path shapes: label -> (nz, nu, N).
K1_SHAPES = {"cartpole": (4, 1, 200), "pendulum": (2, 1, 200),
             "double_cartpole": (6, 1, 200), "rendezvous": (8, 4, 200),
             "pendulum_chol": (5, 1, 200), "bnn": (14, 1, 25)}
H, BATCH = 200, 64


def _chip_smoke():
    """This checkout's chip_smoke.py, for its inputs, launchers and timer:
    its functions import pddp_tpu_torch when called, so they use the
    package of the tree under test."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def raw_k1(derivs, reg):
    """K1 alone on preallocated outputs (``chip_smoke.raw_k1``, or the
    launch without ``ok`` of a K1 that does not write it)."""
    import torch
    from pddp_tpu_torch.ops import backward_kernel as bk
    if hasattr(bk, "INSTANCES"):
        return CS.raw_k1(derivs, reg)
    ins = derivs[1:3] + derivs[4:]
    if ins[0].dim() == 3:
        ins = tuple(t[None] for t in ins)
    B, N, nz, nu = ins[1].shape
    k = torch.empty((B, N, nu), dtype=ins[0].dtype, device=ins[0].device)
    K = torch.empty((B, N, nu, nz), dtype=ins[0].dtype,
                    device=ins[0].device)
    fn = bk._function(ins[0].dtype)
    args = (*(t.data_ptr() for t in ins), float(reg), k.data_ptr(),
            K.data_ptr(), B, N, nz, nu,
            torch.cuda.current_stream().cuda_stream)

    def launch():
        if fn(*args) != 0:
            raise RuntimeError("K1 launch failed")
    return launch


def path_problem(label, dtype):
    """(model, cost, codec, start state) of a path on the card, as
    chip_smoke.py's phase 12 makes them."""
    from pddp_tpu_torch.encoding import StateEncoding
    ex, codec = PATHS[label]
    model, cost, x0 = CS.example(ex, dtype)
    enc = StateEncoding[codec]
    return model, cost, enc, CS.start_state(x0, enc)


def first_iteration_inputs(label):
    """The path's first iteration: the rollout and local model of
    U0 = 0.1, the gains of the plain backward at reg=0 (float32)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (backward, local_model,
                                                 rollout)
    model, cost, enc, z0 = path_problem(label, torch.float32)
    U0 = torch.full((H, model.action_size), 0.1, device="cuda")
    Z0, AUX0 = rollout(model, z0, U0, enc)
    derivs = local_model(Z0, U0, AUX0, model, cost, enc)
    k, K, _ = backward(*derivs, reg=0.0)
    return derivs, [a[None].contiguous() for a in (derivs[0], U0, k, K)]


def host_us(fn, calls=200):
    """Host microseconds per call of ``fn``: ``calls`` calls issued back to
    back on the host clock, then one synchronize (not counted)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def host_times():
    """The wrappers' host time per call at the main path's shape, and that
    of the bare launches they make."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_rollout as fr
    derivs, (Z, U, k, K) = first_iteration_inputs("cartpole")
    model, cost, enc, _ = path_problem("cartpole", torch.float32)
    alphas = default_fit_alphas(torch.float32, "cuda")
    Z, U, k, K = Z[0], U[0], k[0], K[0]
    return {
        "kernel_backward_us": host_us(
            lambda: bk.kernel_backward(*derivs, reg=1.0)),
        "K1_launch_us": host_us(raw_k1(derivs, 1.0)),
        "fused_control_law_us": host_us(lambda: fr.fused_control_law(
            model, Z, U, k, K, alphas, enc, cost=cost)),
        "K2_launch_us": host_us(CS.raw_k2(model, cost, Z, U, k, K, alphas,
                                          enc))}


def path_times(label):
    """One iteration through the kernels (best and median of five runs of
    5) and, but for the belief-state path, two 50-iteration solves."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions,
                                                 default_fit_alphas,
                                                 local_model, rollout, solve,
                                                 trajectory_cost)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_rollout as fr
    model, cost, enc, z0 = path_problem(label, torch.float32)
    ign = enc == StateEncoding.IGNORE_UNCERTAINTY
    U0 = torch.full((H, model.action_size), 0.1, device="cuda")
    alphas = default_fit_alphas(torch.float32, "cuda")
    Z0, AUX0 = rollout(model, z0, U0, enc)

    def iteration():
        derivs = local_model(Z0, U0, AUX0, model, cost, enc)
        k, K, ok = bk.kernel_backward(*derivs, reg=0.0)
        out = fr.fused_control_law(model, derivs[0], U0, k, K, alphas, enc,
                                   cost=cost if ign else None)
        J = out[2] if ign else trajectory_cost(cost, out[0], out[1], enc)
        amin = torch.argmin(torch.where(torch.isfinite(J), J,
                                        torch.inf)).reshape(1)
        return out[0].index_select(1, amin), J[amin]

    runs = [CS.events_ms(iteration, 5, warmup=1) for _ in range(5)]
    res = {"iteration_ms": min(runs),
           "iteration_median_ms": statistics.median(runs)}
    if ign:
        solves = []
        for _ in range(2):
            opts = ILQROptions(n_iterations=50, riccati_mode="kernel",
                               fused_rollout=True)
            t0 = time.perf_counter()
            r = solve(model, cost, z0, U0, opts, encoding=enc)
            torch.cuda.synchronize()
            solves.append({"ms": 1e3 * (time.perf_counter() - t0),
                           "evals": r.evals, "iterations": r.iterations,
                           "state": r.state.name})
        res.update({"solve_ms": min(s["ms"] for s in solves),
                    "solves": solves})
    return res


def turn(tree, label, main_path_only=False):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import pddp_tpu_torch
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import _build
    assert os.path.dirname(pddp_tpu_torch.__file__).startswith(
        os.path.abspath(tree)), pddp_tpu_torch.__file__
    global CS
    CS = cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    out = {"tree": label, "build_s": build_s, "k1": {}, "k2": {},
           "paths": {}}
    for name, (nz, nu, N) in ({} if main_path_only else K1_SHAPES).items():
        row = {}
        for B in (1, BATCH):
            ins = cs.k1_inputs(np.random.default_rng(nz * 10 + nu), B, N, nz,
                               nu, torch.float32, "cuda")
            row["B{}".format(B)] = cs.events_ms(raw_k1(ins, 1.0),
                                                200 if B == 1 else 50)
        out["k1"][name] = row
    alphas = default_fit_alphas(torch.float32, "cuda")
    for name in () if main_path_only else PATHS:
        ex, enc = PATHS[name][0], StateEncoding[PATHS[name][1]]
        row = {}
        for B in (1, BATCH):
            model, cost, ins = cs.k2bc_inputs(np.random.default_rng(0), ex,
                                              enc, B, H, torch.float32)
            row["B{}".format(B)] = cs.events_ms(
                cs.raw_k2(model, cost, *ins, alphas, enc),
                200 if B == 1 else 50)
        if name == "double_cartpole":
            row["first_iteration_B1"] = cs.events_ms(cs.raw_k2(
                model, cost, *first_iteration_inputs(name)[1], alphas, enc),
                200)
        out["k2"][name] = row
    out["host"] = host_times()
    for name in ("cartpole",) if main_path_only else PATHS:
        out["paths"][name] = path_times(name)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="one turn: the checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--parent", help="the parent's checkout: run the turns")
    ap.add_argument("--order", default="change,parent,parent,change",
                    help="the turns, in order")
    ap.add_argument("--main-path-only", action="store_true",
                    help="time the wrappers and the main path alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.tree:
        turn(args.tree, args.label, args.main_path_only)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    turns = []
    for label in args.order.split(","):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--tree", trees[label], "--label", label]
                              + ["--main-path-only"] * args.main_path_only,
                              capture_output=True, text=True,
                              cwd=trees[label])
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))

    def best(get):
        return {lab: min(get(t) for t in turns if t["tree"] == lab)
                for lab in ("parent", "change")}

    def spread(get):
        """Each side's median, quartiles and runs over its turns."""
        out = {}
        for lab in ("parent", "change"):
            runs = [get(t) for t in turns if t["tree"] == lab]
            q = statistics.quantiles(runs, n=4) if len(runs) > 1 else runs * 3
            out[lab] = {"median": statistics.median(runs),
                        "quartiles": [q[0], q[2]], "runs": runs}
        return out

    first = turns[0]
    summary = {"card": card, "order": args.order,
               "k1": {n: {s: best(lambda t: t["k1"][n][s])
                          for s in first["k1"][n]} for n in first["k1"]},
               "k2": {n: {s: best(lambda t: t["k2"][n][s])
                          for s in first["k2"][n]} for n in first["k2"]},
               "host": {s: best(lambda t: t["host"][s])
                        for s in first["host"]},
               "paths": {n: {s: spread(lambda t: t["paths"][n][s])
                             for s in ("iteration_ms", "solve_ms")
                             if s in first["paths"][n]}
                         for n in first["paths"]}}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
