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
and K2(d) alone at the BNN iteration's shape (trained net 6-200-200-8,
P=100, N=25, ten alphas) for one solve and for 64, and F3 for 10 and 640
groups of the net's 100 particles (``chip_smoke.raw_bnn``), each turn
saving K2(d)'s (Z, U, AUX) and F3's output on the same seeded inputs, so
that the summary gives the largest difference between the parent's and
the change's outputs. With ``--main-path-only`` a turn times the
wrappers' host time and the cartpole main path alone, for many short
turns; with ``--bnn-only`` K2(d) and F3 alone; with ``--k2-only`` K2(a)-(c)
at every path and K2(d) and F3 (the K2 lines above), without K1, the host
times or the paths; with ``--k2e-only`` K2(e), the particle line search,
alone at chip_smoke.py's phase 19a rows (``PARTICLE_ROWS``: P=100, N=50,
ten alphas; the five rows' local models and gains, made once by this
checkout before the turns and read by every turn, so that both sides
launch on the same inputs) for one solve and for 64 (``chip_smoke.
batch_of``), in float32, and each row's float32 and float64 outputs at
B=1 saved for the summary's largest parent-change difference and whether
the float64 outputs have the same bits:

    python3 scripts/torch_kernel_ab.py --parent build/parent --k2e-only \
        --order change,parent,parent,change,change,parent,parent,change

(each turn builds only K2(e)'s library); with ``--k1-block`` K1's
block kernel alone at the belief codecs' widths (``chip_smoke.
K1_BLOCK_TIMED``: nz = 20, 27, 42 at nu = 1, 44 and 72 at nu = 4; phase
13's inputs, H=200, reg=10) for one solve and for 64, each turn saving its
gains at B=1 for the summary's largest parent-change difference, the warp
kernel's nu = 4 instances (``chip_smoke.K1_WARP_NU4_TIMED``), the
entry point's float32 fit and MPC ticks at rendezvous under the full
covariance (``chip_smoke.entry_point``, phase 14's configuration), and
where the entry point's rendezvous solves end (state, J, evaluations) in
float64 and float32 through the kernels, the plain backward on the card
and the plain versions on the CPU (``entry_ends``, each side's first
turn):

    python3 scripts/torch_kernel_ab.py --parent build/parent --k1-block \
        --order change,parent,parent,change,change,parent,parent,change

The summary gives each side's median, quartiles and turns.
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


def _adapt_to_tree(cs):
    """Let chip_smoke's launchers drive a tree from before K2's codecs
    (K2(d) packed without an encoding, K2(a)-(c) launched without the
    constrained flag): the BNN packer takes and drops the encoding, and
    ``cs.raw_k2`` launches without the flag."""
    import inspect
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    if "encoding" not in inspect.signature(fb._params).parameters:
        params = fb._params
        fb._params = lambda model, dtype, device, encoding=None: params(
            model, dtype, device)
    try:
        import pddp_tpu_torch.ops._examples  # noqa: F401
    except ImportError:
        cs.raw_k2 = _raw_k2_flagless


def _raw_k2_flagless(model, cost, Z, U, k, K, alphas, enc=None):
    """chip_smoke.raw_k2 for a K2(a)-(c) library without the constrained
    flag."""
    import torch
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    enc = StateEncoding.IGNORE_UNCERTAINTY if enc is None else enc
    if Z.dim() == 2:
        Z, U, k, K = (t[None] for t in (Z, U, k, K))
    B, N, A = U.shape[0], U.shape[1], alphas.shape[0]
    nz, nu = Z.shape[-1], U.shape[-1]
    kind = fr._cost_kind(model, cost, enc)
    params = fr.param_buffer(model, cost if kind else None, Z.dtype,
                             Z.device)
    outs = [torch.empty(s, dtype=Z.dtype, device=Z.device)
            for s in ((B, N + 1, A, nz), (B, N, A, nu), (B, A))]
    fn = fr._function(Z.dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        CS.check(fn(*(t.data_ptr() for t in (Z, U, k, K, alphas, params)),
                    None, outs[0].data_ptr(), outs[1].data_ptr(),
                    outs[2].data_ptr() if kind else None, B, N, A,
                    fr._MODELS[type(model)], int(enc), kind, stream) == 0,
                 "K2 launch")
    return launch


def _takes_regs(bk, block=False):
    """Whether the tree's K1 library takes a reg per solve (a pointer
    after the float reg: one argument more than before)."""
    import torch
    return len(bk._function(torch.float32, block).argtypes) == (
        19 if block else 17)


def _k1_with_ok(ins, reg, block):
    """K1 launched as a library without the reg per solve takes it: the
    outputs k, K, ok (and the block kernel's scratch, none here)."""
    import torch
    from pddp_tpu_torch.ops import backward_kernel as bk
    B, N, nz, nu = ins[1].shape
    k = torch.empty((B, N, nu), dtype=ins[0].dtype, device="cuda")
    K = torch.empty((B, N, nu, nz), dtype=ins[0].dtype, device="cuda")
    ok = torch.empty((B,), dtype=torch.bool, device="cuda")
    fn = bk._function(ins[0].dtype, block)
    args = ((*(t.data_ptr() for t in ins), float(reg), k.data_ptr(),
             K.data_ptr(), ok.data_ptr()) + ((None,) if block else ())
            + (B, N, nz, nu) + ((0,) if block else ())
            + (torch.cuda.current_stream().cuda_stream,))

    def launch():
        if fn(*args) != 0:
            raise RuntimeError("K1 launch failed")
    return launch


def raw_k1(derivs, reg):
    """K1 alone on preallocated outputs (``chip_smoke.raw_k1``, or the
    launch of an older K1: without a reg per solve, or without ``ok``)."""
    import torch
    from pddp_tpu_torch.ops import backward_kernel as bk
    if hasattr(bk, "INSTANCES"):
        if _takes_regs(bk):
            return CS.raw_k1(derivs, reg)
        ins = derivs[1:3] + derivs[4:]
        return _k1_with_ok(tuple(t[None] for t in ins) if ins[0].dim() == 3
                           else ins, reg, False)
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


def bnn_times(label, out_dir):
    """K2(d) at B=1 and 64 and F3 at G=10 and 640 alone (float32), and
    their outputs on the same inputs, saved to out_dir for the summary."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    f32 = torch.float32
    model, _, ins = CS.bnn_inputs(torch, f32, 25, True, 1,
                                  np.random.default_rng(8))
    alphas = default_fit_alphas(f32, "cuda")
    res, saved = {}, {}
    for B in (1, BATCH):
        args = [t.unsqueeze(0).expand((B,) + t.shape).contiguous()
                for t in ins]
        res["K2d_B{}".format(B)] = CS.events_ms(
            CS.raw_bnn(torch, "rollout", model, f32, args + [alphas]),
            200 if B == 1 else 20)
        out = fb.fused_bnn_control_law(model, *args, alphas, ch)
        for name, t in zip(("Z", "U", "AUX"), out):
            saved["K2d_B{}_{}".format(B, name)] = t.cpu()
    for name, t in zip(("Z", "U", "k", "K"), ins):
        saved["input_" + name] = t.cpu()
    for G in (10, 640):
        x = torch.as_tensor(np.random.default_rng(G).standard_normal(
            (G, model.n_particles, 6)), dtype=f32, device="cuda")
        res["F3_G{}".format(G)] = CS.events_ms(
            CS.raw_bnn(torch, "mlp", model, f32, (x,)), 200)
        saved["F3_G{}".format(G)] = fb.mlp(model.net, x).cpu()
    res.update(bnn_iteration(model, alphas))
    torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, label + ".pt"))
    return res


def bnn_iteration(model, alphas):
    """One BNN iteration through the kernels as chip_smoke.py's phase 8
    runs it (local model, K1, K2(d), the cost post-pass, the masked
    argmin): the best of five runs on CUDA events, and one run under
    torch.profiler (device busy ms, idle share, launches)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (local_model, rollout,
                                                 trajectory_cost)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_rollout as fr
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    cost = CartpoleCost(device="cuda", dtype=torch.float32)
    z0, U0 = CS.bnn_start(torch, torch.float32, 25)
    Z0, AUX0 = rollout(model, z0, U0, ch)

    def iteration():
        derivs = local_model(Z0, U0, AUX0, model, cost, ch)
        k, K, _ = bk.kernel_backward(*derivs, reg=1.0)
        Z_b, U_b, _ = fr.fused_control_law(model, derivs[0], U0, k, K,
                                           alphas, ch, with_aux=True)
        J = trajectory_cost(cost, Z_b, U_b, ch)
        return torch.argmin(torch.where(torch.isfinite(J), J, torch.inf))

    runs = [CS.events_ms(iteration, 5, warmup=1) for _ in range(3)]
    prof = CS.device_profile(iteration)
    return {"iteration_ms": min(runs),
            "iteration_device_busy_ms": prof["device_busy_ms"],
            "iteration_idle_share": prof["idle_share"],
            "iteration_launches": prof["kernel_launches"]}


def raw_k1_block(ins, reg):
    """K1's block kernel alone, launched as the tree's library takes it
    (one from before the plan's arguments takes none)."""
    import inspect
    import torch
    from pddp_tpu_torch.ops import backward_kernel as bk
    if "B" in inspect.signature(bk.launch_plan).parameters:
        if _takes_regs(bk, True):
            return CS.raw_k1(ins, reg)
        return _k1_with_ok(ins[1:3] + ins[4:], reg, True)
    d = ins[1:3] + ins[4:]
    B, N, nz, nu = d[1].shape
    k = torch.empty((B, N, nu), device="cuda")
    K = torch.empty((B, N, nu, nz), device="cuda")
    ok = torch.empty((B,), dtype=torch.bool, device="cuda")
    fn = bk._function(torch.float32, True)
    args = (*(t.data_ptr() for t in d), float(reg), k.data_ptr(),
            K.data_ptr(), ok.data_ptr(), None, B, N, nz, nu,
            torch.cuda.current_stream().cuda_stream)

    def launch():
        if fn(*args) != 0:
            raise RuntimeError("K1 block launch failed")
    return launch


def k1_block_times(label, out_dir):
    """K1's block kernel at chip_smoke.K1_BLOCK_TIMED for 1 and 64 solves
    (CUDA events), its gains at B=1 saved to out_dir, and the entry
    point's float32 fit and ticks at rendezvous under the full covariance
    (host clock to synchronize; the second of two runs)."""
    import torch
    from pddp_tpu_torch.ops import backward_kernel as bk
    res, saved = {}, {}
    for name, nz, nu in CS.K1_BLOCK_TIMED:
        ins = CS.k1_inputs(np.random.default_rng(nz), 1, H, nz, nu,
                           torch.float32, "cuda", True, shift=4.0)
        for B in (1, BATCH):
            d = [t if B == 1 else t.expand((B,) + t.shape[1:]).contiguous()
                 for t in ins]
            res["{}_B{}".format(name, B)] = CS.events_ms(
                raw_k1_block(d, 10.0), 200 if B == 1 else 50)
        k, K, _ = bk.kernel_backward(*ins, reg=10.0)
        saved[name + "_k"], saved[name + "_K"] = k.cpu(), K.cpu()
    for name, nz, nu in CS.K1_WARP_NU4_TIMED:
        ins = CS.k1_inputs(np.random.default_rng(nz), 1, H, nz, nu,
                           torch.float32, "cuda", True, shift=4.0)
        for B in (1, BATCH):
            d = [t if B == 1 else t.expand((B,) + t.shape[1:]).contiguous()
                 for t in ins]
            res["warp_{}_B{}".format(name, B)] = CS.events_ms(
                raw_k1(d, 10.0), 200 if B == 1 else 50)
    for _ in range(2):  # the first call also warms the process up
        r = CS.entry_point("rendezvous", "FULL_COVARIANCE_MATRIX", "cuda",
                           torch.float32, "kernel", True)
    res.update({"entry_fit_ms": r["fit_ms"],
                "entry_tick_ms": statistics.median(r["tick_ms"]),
                "entry_evals": sum(r["evals"])})
    torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, label + "_k1.pt"))
    return res


def entry_ends():
    """Where the entry point's solves end at chip_smoke.ENTRY_TIMED
    (rendezvous under both codecs), in float64 and float32: through the
    kernels on the card, through the plain backward on the card (K2 kept)
    and through the plain versions on the CPU. For each, the fit's end
    state, J and evaluations, then the ticks' evaluations and states."""
    import torch
    out = {}
    for label, ex, codec in CS.ENTRY_CASES:
        if label not in CS.ENTRY_TIMED:
            continue
        for dname in ("float64", "float32"):
            for run, device, mode, fused in (
                    ("kernels", "cuda", "kernel", True),
                    ("card_plain_backward", "cuda", "scan", True),
                    ("cpu_plain", "cpu", "scan", False)):
                r = CS.entry_point(ex, codec, device, getattr(torch, dname),
                                   mode, fused)
                out["{}_{}_{}".format(label, dname, run)] = {
                    "state": r["state"], "J": float(r["J"]),
                    "evals": r["evals"], "tick_states": r["tick_states"]}
    return out


def k1_output_differences(out_dir):
    """The largest |parent - change| of each saved gain, relative to the
    largest gain (the first turn of each side)."""
    import torch
    a = torch.load(os.path.join(out_dir, "parent_k1.pt"))
    b = torch.load(os.path.join(out_dir, "change_k1.pt"))
    return {k: float((a[k] - b[k]).abs().max() / a[k].abs().max())
            for k in sorted(a)}


def output_differences(out_dir):
    """The largest |parent - change| of each saved output (the first turn
    of each side), and of K2(d)'s first step alone: U and AUX of step 0,
    which no moment match has touched, and Z after the first one."""
    import torch
    a = torch.load(os.path.join(out_dir, "parent.pt"))
    b = torch.load(os.path.join(out_dir, "change.pt"))
    out = {k: float((a[k] - b[k]).abs().max()) for k in sorted(a)}
    for B in (1, BATCH):
        for name, i in (("U", 0), ("AUX", 0), ("Z", 1)):
            k = "K2d_B{}_{}".format(B, name)
            # AUX comes back (N, B, ...), Z and U (B, N, ...).
            x, y = ((a[k][i], b[k][i]) if name == "AUX"
                    else (a[k][:, i], b[k][:, i]))
            out["{}_step{}".format(k, i)] = float((x - y).abs().max())
    return out


def k2e_inputs(out_dir):
    """Each phase-19a row's inputs, made as chip_smoke.py's phase 19a makes
    them but with the plain backward in place of K1 (whose library this
    turn does not build): the local model of U0 and the gains at the first
    reg of PARTICLE_K1_REGS that keeps them finite, in float32 and
    float64, saved to out_dir/k2e_inputs.pt for every turn."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (backward, local_model,
                                                 rollout)
    from pddp_tpu_torch.encoding import StateEncoding
    saved = {}
    for label, _, codec, _ in CS.PARTICLE_ROWS:
        enc = StateEncoding[codec]
        for dtype in (torch.float32, torch.float64):
            model, cost, z0, U0 = CS.particle_problem(label, "cuda", dtype)
            Z, AUX = rollout(model, z0, U0, enc)
            derivs = local_model(Z, U0, AUX, model, cost, enc)
            for reg in CS.PARTICLE_K1_REGS:
                k, K, ok = backward(*derivs, reg=reg)
                if bool(ok):
                    break
            if not bool(ok):
                raise RuntimeError("{} {}: gains finite at no reg"
                                   .format(label, dtype))
            key = "{}_{}".format(label, str(dtype).replace("torch.", ""))
            saved[key] = {"Z": derivs[0].cpu(), "U": U0.cpu(),
                          "k": k.cpu(), "K": K.cpu(), "reg": reg}
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, "k2e_inputs.pt"))


def k2e_times(label, out_dir, inputs_dir):
    """K2(e) alone at each phase-19a row, float32, B=1 and 64 (CUDA
    events), on the saved inputs; its float32 and float64 outputs at B=1
    saved to out_dir."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    inputs = torch.load(os.path.join(inputs_dir, "k2e_inputs.pt"))
    res, saved = {}, {}
    for row, _, codec, _ in CS.PARTICLE_ROWS:
        enc = StateEncoding[codec]
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).replace("torch.", "")
            ins = inputs["{}_{}".format(row, dname)]
            model = CS.particle_problem(row, "cuda", dtype)[0]
            Z, U, k, K = (ins[n].to("cuda") for n in ("Z", "U", "k", "K"))
            alphas = default_fit_alphas(dtype, "cuda")
            out = fpr.fused_particle_control_law(model, Z, U, k, K, alphas,
                                                 enc)
            for name, t in zip(("Z", "U", "AUX"), out):
                saved["{}_{}_{}".format(row, dname, name)] = t.cpu()
            if dtype != torch.float32:
                continue
            batch = CS.batch_of(np.random.default_rng(19), Z, U, k, K, BATCH)
            res[row] = {
                "B1": CS.events_ms(CS.raw_k2e(model, Z, U, k, K, alphas,
                                              enc), 200),
                "B{}".format(BATCH): CS.events_ms(
                    CS.raw_k2e(model, *batch, alphas, enc), 50)}
    torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, label + "_k2e.pt"))
    return res


def k2e_output_differences(out_dir):
    """The largest |parent - change| of each saved K2(e) output, relative
    to its largest value, and whether the float64 outputs are the same
    bits (the first turn of each side)."""
    import torch
    a = torch.load(os.path.join(out_dir, "parent_k2e.pt"))
    b = torch.load(os.path.join(out_dir, "change_k2e.pt"))
    out = {k: float((a[k] - b[k]).abs().max() / a[k].abs().max())
           for k in sorted(a)}
    out["float64_same_bits"] = all(torch.equal(a[k], b[k]) for k in a
                                   if "_float64_" in k)
    return out


def build_k2e():
    """Builds K2(e)'s two libraries at once, through the tree's own
    `ops/_build.py`."""
    from pddp_tpu_torch.ops import _build
    name = "fused_particle_rollout"
    jobs = [(_build._start(name, d)) for d in _build.DTYPES
            if not _build._target(name, d).exists()]
    for job in jobs:
        _build._finish(name, *job)


def turn(tree, label, main_path_only=False, bnn_only=False, out_dir=None,
         k1_block=False, ends=False, k2_only=False, k2e_only=False,
         inputs_dir=None):
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
    _adapt_to_tree(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    if k2e_only:
        build_k2e()
    else:
        _build.build_all()
    build_s = time.perf_counter() - t0
    out = {"tree": label, "build_s": build_s, "k1": {}, "k2": {},
           "paths": {}, "bnn": {}, "k1_block": {}, "k2e": {}}
    if k2e_only:
        if label == "inputs":
            k2e_inputs(out_dir)
        else:
            out["k2e"] = k2e_times(label, out_dir, inputs_dir)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        return
    if k1_block:
        out["k1_block"] = k1_block_times(label, out_dir)
        if ends:
            out["entry_ends"] = entry_ends()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        return
    if not main_path_only:
        out["bnn"] = bnn_times(label, out_dir)
    if bnn_only:
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        return
    for name, (nz, nu, N) in ({} if main_path_only or k2_only
                              else K1_SHAPES).items():
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
    if k2_only:
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        return
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
    ap.add_argument("--bnn-only", action="store_true",
                    help="time K2(d) and F3 alone")
    ap.add_argument("--k2-only", action="store_true",
                    help="time K2(a)-(c) at the paths, K2(d) and F3 alone")
    ap.add_argument("--k2e-only", action="store_true",
                    help="time K2(e) alone at phase 19a's rows")
    ap.add_argument("--inputs", help="with --k2e-only and --tree: where "
                    "the rows' inputs were saved")
    ap.add_argument("--k1-block", action="store_true",
                    help="time K1's block kernel and the entry point alone")
    ap.add_argument("--ends", action="store_true",
                    help="with --k1-block: also where the entry point's "
                    "rendezvous solves end (a side's first turn)")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "ab"),
                    help="where the turns save their outputs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.tree:
        turn(args.tree, args.label, args.main_path_only, args.bnn_only,
             args.out, args.k1_block, args.ends, args.k2_only,
             args.k2e_only, args.inputs)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    out_dir = os.path.abspath(args.out)
    if args.k2e_only:  # the rows' inputs, made once by this checkout
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--tree", HERE, "--label", "inputs",
                               "--k2e-only", "--out", out_dir],
                              capture_output=True, text=True, cwd=HERE)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    turns = []
    for label in args.order.split(","):
        first = not any(t["tree"] == label for t in turns)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--tree", trees[label], "--label", label,
                               "--out", os.path.abspath(args.out)
                               if first else os.path.join(
                                   os.path.abspath(args.out), "later")]
                              + ["--main-path-only"] * args.main_path_only
                              + ["--bnn-only"] * args.bnn_only
                              + ["--k2-only"] * args.k2_only
                              + ["--k2e-only", "--inputs", out_dir]
                              * args.k2e_only
                              + ["--k1-block"] * args.k1_block
                              + ["--ends"] * (args.k1_block and first),
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
    if args.k2e_only:
        summary = {"card": card, "order": args.order,
                   "k2e": {r: {s: spread(lambda t: t["k2e"][r][s])
                               for s in first["k2e"][r]}
                           for r in first["k2e"]},
                   "k2e_output_max_rel_diff": k2e_output_differences(
                       out_dir)}
        print(json.dumps({"summary": summary}), flush=True)
        return 0
    summary = {"card": card, "order": args.order,
               "k1": {n: {s: best(lambda t: t["k1"][n][s])
                          for s in first["k1"][n]} for n in first["k1"]},
               "k2": {n: {s: best(lambda t: t["k2"][n][s])
                          for s in first["k2"][n]} for n in first["k2"]},
               "host": {s: best(lambda t: t["host"][s])
                        for s in first.get("host", {})},
               "bnn": {s: spread(lambda t: t["bnn"][s])
                       for s in first["bnn"]},
               "k1_block": {s: spread(lambda t: t["k1_block"][s])
                            for s in first["k1_block"]},
               "paths": {n: {s: spread(lambda t: t["paths"][n][s])
                             for s in ("iteration_ms", "solve_ms")
                             if s in first["paths"][n]}
                         for n in first["paths"]}}
    if first["bnn"]:
        summary["bnn_output_max_abs_diff"] = output_differences(args.out)
    if first["k1_block"]:
        summary["k1_block_gain_max_rel_diff"] = k1_output_differences(
            args.out)
        summary["entry_ends"] = {t["tree"]: t["entry_ends"] for t in turns
                                 if "entry_ends" in t}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
