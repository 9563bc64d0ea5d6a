#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``pddp_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pddp_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, solves the golden cartpole
problem through them in float64 and float32 against
``tests/golden/solver_trajectories.npz``, and times the two paths through
the kernels and through the plain versions: the known-dynamics cartpole
iLQR solve (horizon 200, ten step sizes; phases 1-5), the belief-state
BNN iteration and solve (100 particles, net 6-200-200-8, Cholesky belief,
horizon 25; phases 7-9), and the other known-dynamics examples: K2 stages
(b) and (c) against their plain version (phase 10), the eight golden
solves of tests/golden/cases.py in float64 (phase 11), and the pendulum,
double cartpole, rendezvous and belief-state pendulum paths at horizon 200
(phase 12); phase 13 times K1 and K2 alone at every path's shape beside
their bounds, K2(d) at the BNN iteration's for 1 and 64 solves, and K1's
block kernel at the belief codecs' widths. Phase 14 drives the entry
point, ``iLQRController.fit`` and two ``forward(mpc=True)`` ticks,
through K1 and K2 on the four examples under the Cholesky codec and two
under the full covariance, against the plain versions on the CPU. Phase
15 runs the PDDP episodic loop (``PDDPController``: exploration, BNN
training with ``fit_bnn``, the iLQR fit on the learned belief model, MPC
collection) at the examples' full width: one trial on the card against
the CPU in float64, examples/experiment.py's cartpole trial timed in
float32 with K1 and K2(d) checked on the model it trained,
scripts/make_trained_bnn.py's training recipe, and the learning test's
pendulum run. Phase 16 runs bench.py's batched solves. Phase 17 solves
the particle model (``particulate_model``, 100 particles, horizon 100,
N=50) of the cartpole under three codecs and constrained, and of the
rendezvous, through K1, timed by the port's ``PhaseTimer``, with K1 held
against its plain version on each row and the cartpole rows in float64
against the CPU. Phase 18 runs the port's multi-GPU paths on
``torch.distributed`` in a 1-rank NCCL world and in a 2-rank gloo world
with both ranks on the one card: bench.py's cartpole batch sharded over
the ranks through K1 and K2(a), the particle-sharded solve of phase 8's
BNN through K1 (float64 against the unsharded solve, float32 timed) and
one ``dp_train_step``. Phases 19 and 20 run the rest of K2's gate and the
BNN's bfloat16 knobs; phase 21 runs K2(f), the line search of any
stateless model traced from its torch code, on the rows of
``tests/traced_models.py``; phase 22 runs K2(g), the line search of a
user's stateful model traced from its torch code, and K2(e) over a
traced inner step, on its stateful rows. The timed kernel-versus-plain
comparisons take one turn each. Each phase prints one JSON line; any failure raises and exits non-zero. The
run's seconds, the card line, the kernels line and, last,
``{"ok": true, "device": {...}}`` close it. Without a CUDA device it
exits 1 and prints no result. It imports neither JAX nor ``pddp_tpu``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "solver_trajectories.npz")

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# Kernel-versus-plain tolerances on max|kernel - plain| / max|plain|.
# float64: both sides do the same arithmetic, apart from the order of
# sums and fused multiply-adds. float32: the same, over a 200-step chain.
TOL = {("K1", "float64"): 1e-10, ("K1", "float32"): 1e-4,
       ("K2", "float64"): 1e-10, ("K2", "float32"): 1e-5}


# K1's block kernel (every (nz, nu <= 4) without a warp instance): float64
# 1e-10 at nu = 1 and 1e-8 at nu > 1, where both sides run the same Jacobi
# and the eigenvector conditioning amplifies its rounding. float32: the
# kernel against the float64 plain version within the larger of 1e-4 and
# twice the float32 plain version's own error there; at these widths the
# float32 recursion itself strays up to ~2e-4 from float64 over 200 steps
# (nz = 42 on phase 1's inputs), past a kernel-versus-plain 1e-4.
K1_BLOCK_TOL = {("float64", 1): 1e-10, ("float64", 4): 1e-8,
                ("float32", 1): 1e-4}
# The most the float32 check may widen to: the float32 plain version's own
# error against float64 must stay below it (else the inputs, not the
# kernel, are at fault and the case fails), and so must the kernel's
# distance to the float32 plain version.
K1_BLOCK_F32_CAP = 1e-3

# (nz, nu) of the block kernel in phase 1: nu = 2, 3 at no bundled shape,
# the belief codecs' widths (cartpole full covariance 20, double cartpole
# Cholesky 27 and full 42, rendezvous Cholesky 44 and full 72), and one
# past shared memory in float64 (100, 2), which runs on a scratch buffer.
K1_BLOCK_SHAPES = [(3, 2), (10, 3), (20, 1), (27, 1), (42, 1), (44, 4),
                   (72, 4)]
K1_SCRATCH_SHAPE = (100, 2)
# (nz, nu, cluster) run with a plan other than the library's, so that every
# nu runs both one CTA a solve and a cluster: the library takes a cluster
# only where a step has enough work to split (``ops.backward_kernel.
# launch_plan``), so the narrow shapes are asked for one here, and the
# wide ones for a single CTA.
K1_BLOCK_FORCED = [(20, 1, 2), (27, 1, 4), (42, 1, 1), (3, 2, 2),
                   (10, 3, 2), (44, 4, 1), (72, 4, 1), (72, 4, 8)]


# The turns of the timed kernel-versus-plain comparisons (phases 5, 8, 12
# and 14): one each, kernels first. The plain sides run 3-35x slower, far
# past the spread of repeated turns.
TURNS = (True, False)

# (B, N) of the batched kernel cases (phases 1, 2 and 10): one solve of
# one step, a ragged block of three, a full batch at an eighth of the
# bench horizon (cut from N=200, then from 100 and 50, for the run's
# time; phase 13 times every kernel at the bench horizon, and
# phase 1 holds K1 there at B=1 and B=1024).
BATCHES = [(1, 1), (3, 37), (64, 25)]


def k1_block_tol(dtype_name, nu):
    return K1_BLOCK_TOL[(dtype_name, 1 if nu == 1 or dtype_name ==
                         "float32" else 4)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def reset_counts(counts):
    """Sets every launch count of a wrapper's dict to 0."""
    for key in counts:
        counts[key] = 0


def rel_err(a, b):
    """(max abs error, max abs error / max |b|) of a against b."""
    d = float((a - b).abs().max())
    return d, d / max(float(b.abs().max()), 1e-300)


def events_ms(fn, repeats, warmup=3):
    """Mean device-clock time of ``fn`` over ``repeats`` back-to-back
    calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: the wall time, the device
    time summed over its kernels, the idle share, and the kernels that
    took the most device time (names cut to 90 characters). The profiler
    records the device's activity alone (the host's ops would add nothing
    read here and cost tens of seconds to read back at tens of thousands
    of launches); reading back still takes ~0.2 ms a launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.device_time_total)
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(n for n, _ in by_name.values()),
            "top": [{"name": name[:90], "count": n, "ms": us / 1e3}
                    for name, (n, us) in top]}


def raw_k1(derivs, reg):
    """A closure launching K1 alone on preallocated outputs (no checks),
    for the kernel's own device time; derivs of one solve or of a batch,
    ``reg`` a float or a tensor (B,) on the card, a reg per solve."""
    import torch
    from pddp_tpu_torch.ops import backward_kernel as bk
    ins = derivs[1:3] + derivs[4:]
    if derivs[1].dim() == 3:
        ins = tuple(t[None] for t in ins)
    B, N, nz, nu = ins[1].shape
    k = torch.empty((B, N, nu), dtype=ins[0].dtype, device=ins[0].device)
    K = torch.empty((B, N, nu, nz), dtype=ins[0].dtype,
                    device=ins[0].device)
    ok = torch.empty((B,), dtype=torch.bool, device=ins[0].device)
    outs = [k.data_ptr(), K.data_ptr(), ok.data_ptr()]
    block = (nz, nu) not in bk.INSTANCES
    sizes = (B, N, nz, nu)
    if block:   # the block kernel, with its scratch where it needs one
        elems = bk.launch_plan(nz, nu, ins[0].dtype, B)["scratch_elems"]
        scratch = torch.empty((B, max(elems, 1)), dtype=ins[0].dtype,
                              device=ins[0].device)
        outs.append(scratch.data_ptr() if elems else None)
        sizes += (0,)  # the library's plan
    fn = bk._function(ins[0].dtype, block)
    stream = torch.cuda.current_stream().cuda_stream
    regs = reg.data_ptr() if isinstance(reg, torch.Tensor) else None
    reg = 0.0 if regs is not None else float(reg)

    def launch():
        check(fn(*(t.data_ptr() for t in ins), reg, regs, *outs, *sizes,
                 stream) == 0, "K1 launch")
    return launch


def raw_k2(model, cost, Z, U, k, K, alphas, enc=None):
    """A closure launching K2 (stages a-c) alone on preallocated outputs,
    for one solve (Z (N+1, nz), U (N, nu), ...) or a batch; under a belief
    codec without the cost, as the solve calls it."""
    import torch
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.ops._examples import MODELS, example_of
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

    base, constrained = example_of(model)
    which = (MODELS[base], int(enc), kind, int(constrained))

    def launch():
        check(fn(*(t.data_ptr() for t in (Z, U, k, K, alphas, params)),
                 None, outs[0].data_ptr(), outs[1].data_ptr(),
                 outs[2].data_ptr() if kind else None, B, N, A, *which,
                 stream) == 0,
              "K2 launch")
    return launch


# ---------------------------------------------------------------------------
# Work counts for the roofline bound (bytes moved once, operations done)
# ---------------------------------------------------------------------------


def k1_work(B, N, nz, nu, itemsize, sweeps):
    """(bytes, operations) of one K1 call: each input read once, each
    output written once; multiply-adds count 2, a sine or division 1."""
    n_in = (N * (nz * nz + nz * nu + nu + nu * nz + nu * nu)
            + (N + 1) * (nz + nz * nz))
    n_out = N * (nu + nu * nz)
    step = (2 * nz**3 + 2 * nz * nz * nu + 2 * nz * nz + nz       # VF, Q_z
            + 2 * nz * nu + nu                                     # Q_u
            + 2 * nz**3 + nz * nz + 2 * nz * nz * nu + nz * nu     # Q_zz, Q_uz
            + 2 * nz * nu * nu + nu * nu + 2 * nz * nz + 2 * nu * nu
            + 2 * nu * nu + 2 * nu * nu * nz                       # k, K
            + nz * (nu * (2 * nu + 3) + 2 * nu + 2)                # V_z
            + nz * nz * (2 * nu * nu + 6 * nu + 3) + 2 * nz * nz)  # V_zz
    if nu == 1:
        step += 3
    else:
        rotations = sweeps * nu * (nu - 1) // 2
        step += rotations * (19 + 6 * (nu - 2) + 6 * nu) + 3 * nu**3
    return B * (n_in + n_out) * itemsize, B * N * step


# Operations of one mean step of each example's model (multiply-adds count
# 2; a sine, cosine, division or square root 1), and of its angular
# augmentation (the sines and cosines), as csrc/fused_rollout.cu does them.
MODEL_OPS = {"cartpole": 41, "pendulum": 15, "double_cartpole": 117,
             "rendezvous": 44}
SIZES = {"cartpole": (4, 1, 5), "pendulum": (2, 1, 3),
         "double_cartpole": (6, 1, 8), "rendezvous": (8, 4, 8)}


def k2_work(B, N, A, itemsize, bounded, name="cartpole", codec=4,
            with_cost=True):
    """(bytes, operations) of one K2 call (stages a-c) of example ``name``
    under codec ``codec`` (StateEncoding's value): each input read once,
    each output written once. The operations per candidate and step: the
    feedback law, the clamp, the in-kernel cost (IGNORE_UNCERTAINTY), the
    model's mean step and the belief part's decode and re-encode (under
    the Cholesky codec for rendezvous, U^T U and the ladder's first rung,
    the one that factorizes these inputs)."""
    n, nu, n_aug = SIZES[name]
    nz = {0: n + n * n, 1: n + n * (n + 1) // 2, 2: 2 * n, 3: 2 * n,
          4: n}[codec]
    ny = n_aug if name != "rendezvous" else n
    cost = with_cost and codec == 4
    n_params = 8 + ((2 * ny * ny + nu * nu + ny + nu) if cost else 0)
    n_in = B * ((N + 1) * nz + 2 * N * nu + N * nu * nz) + A + n_params + (
        2 * nu if bounded else 0)
    n_out = B * ((N + 1) * A * nz + N * A * nu + (A if cost else 0))
    state_cost = 2 * ny * ny + 3 * ny + (n_aug - n)
    belief = {0: 0, 2: 0, 3: 2 * n, 4: 0, 1: n * (n + 1) + n}[codec]
    if name == "rendezvous" and codec == 1:
        belief = (n * (n + 1) * (2 * n + 1) // 3 + n**3 // 3
                  + n * (n + 1) // 2)
    step = (nu * (2 * nz + 3) + (2 * nu if bounded else 0)
            + (state_cost + 2 * nu * nu + 3 * nu + 1 if cost else 0)
            + MODEL_OPS[name] + belief)
    return ((n_in + n_out) * itemsize,
            B * A * (N * step + (state_cost if cost else 0)))


# The chain floor of a latency-chain kernel: N times the latency of the
# dependent instructions on one step's critical path, counted by hand from
# csrc/backward_kernel.cu and csrc/fused_rollout.cu, at these latencies in
# SM cycles. Assumed, not measured on the card: a dependent FP32 FMA, add
# or multiply 4 cycles and an FP64 one 8 (published microbenchmarks of
# Volta to Hopper), an IEEE division or square root a special-function
# approximation (~18 cycles) and 3 (FP32) or 6 (FP64) dependent FMAs, a
# sine or cosine (no special-function unit on the precise path) 11 (FP32)
# or 15 (FP64) dependent FMAs of range reduction and polynomial, a
# cluster barrier (barrier.cluster arrive and wait) 200 cycles. Shared
# memory's latency is left out: a floor that kept everything in registers.
LATENCY = {"float32": {"fma": 4, "div": 30, "sqrt": 30, "sincos": 44,
                       "cluster_sync": 200},
           "float64": {"fma": 8, "div": 66, "sqrt": 66, "sincos": 120,
                       "cluster_sync": 200}}


def k1_chain_cycles(nz, nu, dtype_name, sweeps=None):
    """Cycles of one K1 step's critical path: stage A's nz-long product and
    its add, stage B's nz-long product, its add and the symmetrization,
    then stage C: for nu=1 the clamp (2) and the reciprocal, for nu > 1
    the clamp as csrc/backward_kernel.cu:clamped_inverse builds it: the
    power-of-two scaling (9), ``sweeps`` sweeps (the mean this
    run's data needs, ``k1_sweeps``; the fixed count when None) of the
    round-robin pairs, whose two rotations of a round at nu = 4 run side
    by side (3 rounds a sweep at nu = 3, 4; 1 at nu = 2; each rotation one
    square root, one reciprocal and one reciprocal square root, in float32
    each followed by its Newton step, and 10-19 dependent adds and
    multiplies; at nu = 4 two more for the cross terms) and the exit test
    (3), the eigenvalues' reciprocals and the inverse (a division and
    nu + 3), M (2 nu), then a gain column (nu), Q_uu K (nu), the quadratic
    form (nu), three adds and the symmetrization (2). The same for the
    warp and the block kernel: it counts what the function needs, not a
    design's barriers."""
    lat = LATENCY[dtype_name]
    fma, div, sqrt = lat["fma"], lat["div"], lat["sqrt"]
    if nu == 1:
        return (2 * nz + 13) * fma + div
    f32 = dtype_name == "float32"
    if sweeps is None:
        sweeps = 5 if f32 else 8
    rounds = 1 if nu == 2 else 3
    rotation = (19 if f32 else 10) * fma + 2 * sqrt + div
    round_ = rotation + (2 * fma if nu == 4 else 0)
    clamp = (9 * fma + sweeps * (rounds * round_ + 3 * fma)
             + div + (nu + 3 + (2 if f32 else 0)) * fma + 2 * nu * fma)
    return (2 * nz + 12 + 3 * nu) * fma + clamp


def k1_chain_cycles_cyclic(nz, nu, dtype_name):
    """k1_chain_cycles of the clamp as first built (cyclic pairs, 5 or 8
    full sweeps, 3 divisions and 2 square roots a rotation), for that bound
    beside the current one."""
    lat = LATENCY[dtype_name]
    if nu == 1:
        return (2 * nz + 13) * lat["fma"] + lat["div"]
    rotations = (8 if dtype_name == "float64" else 5) * nu * (nu - 1) // 2
    return ((2 * nz + 12 + 4 * nu + 9 * rotations) * lat["fma"]
            + (3 * rotations + 1) * lat["div"]
            + 2 * rotations * lat["sqrt"])


# The kernels' Jacobi pair order (csrc/backward_kernel.cu:jacobi_pair,
# round robin: the two rotations of a round at nu = 4 are disjoint).
JACOBI_PAIRS = {2: [(0, 1)], 3: [(0, 1), (0, 2), (1, 2)],
                4: [(0, 1), (2, 3), (0, 2), (1, 3), (0, 3), (1, 2)]}


def clamp_as_built(Q, dtype_name):
    """csrc/backward_kernel.cu:clamped_inverse (nu = 2-4) in numpy, over a
    batch of symmetric Q (n, nu, nu) in the run's type: Q scaled by a power
    of two to its largest entry in [0.5, 1), the round-robin pairs, the
    rotation t = sgn(tau) |h| / (|d| + sqrt(d^2 + h^2)) with
    c = 1 / sqrt(1 + t^2), and each Q's exit after a sweep in which every
    |a_pq| <= eps sqrt(|a_pp a_qq|). (The card's float32 reciprocal and
    reciprocal square root are within an ulp of numpy's.) Returns the
    eigenvalues e (n, nu), the eigenvectors E (n, nu, nu) and the sweeps
    each Q ran (n,); the clamped inverse is E diag(1 / (max(e, 1e-12) +
    reg)) E^T."""
    dt = np.float32 if dtype_name == "float32" else np.float64
    f, one = np.finfo(dt), dt(1)
    Q = np.asarray(Q, dt)
    n, nu = Q.shape[0], Q.shape[-1]
    full = 5 if dt == np.float32 else 8
    max_exp = 120 if dt == np.float32 else 1000
    m = np.abs(np.triu(Q)).max(axis=(-1, -2))
    ex = np.where((m > 0) & np.isfinite(m), np.frexp(m)[1], 0)
    ex = np.clip(ex, -max_exp, max_exp)
    a = (Q * np.ldexp(one, -ex).astype(dt)[:, None, None]).astype(dt)
    v = np.broadcast_to(np.eye(nu, dtype=dt), (n, nu, nu)).copy()
    done = np.full(n, full)
    active = np.ones(n, bool)
    for sweep in range(1, full + 1):
        for p, q in JACOBI_PAIRS[nu]:
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            live = apq != 0
            d, h = aqq - app, dt(2) * np.where(live, apq, one)
            x = np.maximum(d * d + h * h, f.tiny)
            den = np.abs(d) + np.sqrt(x)
            pos = (d == 0) | ((d > 0) == (h > 0))
            t = np.where(pos, np.abs(h), -np.abs(h)) * (one / den)
            c = one / np.sqrt(t * t + one)
            s = t * c
            # A Q that has exited, or whose a_pq is zero, is left as it is.
            turn = live & active
            t, c, s = (np.where(turn, t, 0).astype(dt),
                       np.where(turn, c, 1).astype(dt),
                       np.where(turn, s, 0).astype(dt))
            for k in range(nu):
                if k not in (p, q):
                    akp, akq = a[:, k, p].copy(), a[:, k, q].copy()
                    a[:, k, p] = a[:, p, k] = c * akp - s * akq
                    a[:, k, q] = a[:, q, k] = s * akp + c * akq
            a[:, p, p], a[:, q, q] = app - t * apq, aqq + t * apq
            a[:, p, q] = a[:, q, p] = np.where(active, 0, apq)
            vp, vq = v[:, :, p].copy(), v[:, :, q].copy()
            v[:, :, p] = c[:, None] * vp - s[:, None] * vq
            v[:, :, q] = s[:, None] * vp + c[:, None] * vq
        conv = np.ones(n, bool)
        for p in range(nu):
            for q in range(p + 1, nu):
                conv &= (a[:, p, q] * a[:, p, q]
                         <= f.eps * f.eps * np.abs(a[:, p, p] * a[:, q, q]))
        done[active & conv] = sweep
        active &= ~conv
    e = (np.diagonal(a, axis1=-2, axis2=-1)
         * np.ldexp(one, ex).astype(dt)[:, None]).astype(dt)
    return e, v, done


def k1_sweeps(derivs, reg, dtype_name="float32"):
    """The mean sweeps of the kernels' Jacobi over the steps of solve 0 of
    these K1 inputs: Q_uu of every step from the plain recursion (float64,
    numpy), then clamp_as_built in the run's type. None at nu = 1. ``reg``
    a float, or a reg per solve (solve 0's is taken)."""
    if not isinstance(reg, float):
        reg = float(np.asarray(reg.detach().cpu()).reshape(-1)[0])
    Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu = [
        t.detach().double().cpu().numpy() for t in derivs]
    if F_z.ndim == 4:
        F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu = (
            x[0] for x in (F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu))
    nu = F_u.shape[-1]
    if nu == 1:
        return None
    V, v, quu = L_zz[-1], L_z[-1], []
    for i in reversed(range(F_z.shape[0])):
        Fz, Fu = F_z[i], F_u[i]
        Qz, Qu = L_z[i] + Fz.T @ v, L_u[i] + Fu.T @ v
        Qzz = L_zz[i] + Fz.T @ V @ Fz
        Quz = L_uz[i] + Fu.T @ V @ Fz
        Quu = L_uu[i] + Fu.T @ V @ Fu
        Qzz, Quu = (Qzz + Qzz.T) / 2, (Quu + Quu.T) / 2
        quu.append(Quu)
        e, E = np.linalg.eigh(Quu)
        Qi = (E / (np.where(e < 0, 1e-12, e) + reg)) @ E.T
        k, K = -Qi @ Qu, -Qi @ Quz
        v = Qz + K.T @ Quu @ k + K.T @ Qu + Quz.T @ k
        V = Qzz + K.T @ Quu @ K + K.T @ Quz + Quz.T @ K
        V = (V + V.T) / 2
    return float(clamp_as_built(np.stack(quu), dtype_name)[2].mean())


# Peak multiply-adds a cycle of one SM (4 sub-partitions; the H100's
# published FP32 and FP64 rates over 132 SMs at 1980 MHz).
SM_FMA_PER_CYCLE = {"float32": 128, "float64": 64}


def c_sm_ms(flops, B, c, dtype_name):
    """The least time of K1's block kernel at its plan, each solve on the c
    SMs of its cluster (c = 1: one SM): the operations of the busiest SM
    (ceil(B c / 132) waves of 1 / c of a solve) at one SM's peak rate. Not a
    bound of the card, which could spread a solve wider; it says what holds
    the plan back."""
    per_solve = flops / B / 2.0     # multiply-adds
    waves = -(-B * c // 132)
    return (1e3 * waves * per_solve / c
            / (SM_FMA_PER_CYCLE[dtype_name] * max_sm_clock_mhz() * 1e6))


def k2_chain_cycles(name, codec, nz, dtype_name, bounded=False):
    """Cycles of one K2 step's critical path for one candidate: the
    feedback z -> u (a subtraction, nz FMAs, two adds, the clamp) and the
    model step from u and from the angles' sines to the next state, and
    under the Cholesky codec the belief's decode and refactorization
    (n square roots and n divisions behind 2n FMAs), which feeds the next
    feedback in parallel with the mean."""
    lat = LATENCY[dtype_name]
    fma, div, sc = lat["fma"], lat["div"], lat["sincos"]
    u = (nz + 3 + (2 if bounded else 0)) * fma
    if name == "cartpole":    # a2 joins a2 cos(theta); 4 ops, /, 2 FMAs
        mean = max(u + fma, sc) + 6 * fma + div
    elif name == "pendulum":  # u - mu td and sin's term, *3, /, td'
        mean = max(u + fma, sc + fma) + 3 * fma + div
    elif name == "double_cartpole":  # trig -> A -> minors -> det -> /
        mean = max(sc + 7 * fma + div, u + 4 * fma) + 5 * fma
    else:                     # rendezvous: u dt / m, acc, x'
        mean = u + 3 * fma + div
    n = SIZES[name][0]
    belief = (n * (lat["sqrt"] + div) + 2 * n * fma) if codec == 1 else 0
    return max(mean, belief)


def k2d_chain_cycles(n, nz, widths, P, dtype_name, codec=1):
    """Cycles of one K2(d) step's critical path (csrc/fused_bnn_rollout.cu):
    the feedback law's nz-long chain and its two adds; the noise solve's n
    chained subtract-and-divides; the particle's n-long sum; the net
    input's sine, subtraction and division; each layer's K-long FMA chain
    and its bias and mask; the next state's two; the sums over P of the
    mean and then the covariance, as trees (the least depth of any order);
    under the matrix codecs (``codec`` StateEncoding's value) the n x n
    Cholesky (n square roots and divisions behind 2n FMAs: CHOL's encode,
    FULL's decode), under VAR and STD one square root, under IGNORE
    neither the second sums nor a root; one cluster barrier."""
    lat = LATENCY[dtype_name]
    fma, div = lat["fma"], lat["div"]
    depth = int(np.ceil(np.log2(P)))
    moments = {0: 2 * depth * fma + n * (lat["sqrt"] + div) + 2 * n * fma,
               1: 2 * depth * fma + n * (lat["sqrt"] + div) + 2 * n * fma,
               2: 2 * depth * fma + lat["sqrt"],
               3: 2 * depth * fma + lat["sqrt"],
               4: depth * fma}[codec]
    return ((nz + 3) * fma + n * (fma + div) + n * fma
            + lat["sincos"] + fma + div
            + (sum(widths[:-1]) + 2 * (len(widths) - 1)) * fma + 2 * fma
            + moments + lat["cluster_sync"])


def chain_ms(cycles, N, clock_mhz):
    return 1e3 * N * cycles / (clock_mhz * 1e6)


@functools.lru_cache(maxsize=None)
def max_sm_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0])


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def chain_bound_ms(nbytes, flops, dtype_name, cycles, N):
    """The bound of a latency-chain kernel (K1, K2(a)-(d)): the larger of
    the roofline (``bound_ms``) and its chain floor, N dependent steps of
    ``cycles`` each at the card's maximum SM clock. The chain is operations
    too, bound by their latency rather than their rate, so "by" says
    "operations" where it wins. Returns (bound, by, roofline, chain)."""
    roof, by = bound_ms(nbytes, flops, dtype_name)
    chain = chain_ms(cycles, N, max_sm_clock_mhz())
    return max(roof, chain), (by if roof >= chain else "operations"), \
        roof, chain


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def k1_inputs(rng, B, N, nz, nu, dtype, device, indefinite=False,
              shift=2.0):
    """Seeded Riccati inputs with a PSD joint Hessian of (z, u) per step
    (so L_zz and L_uu are PSD); ``indefinite`` shifts L_uu of the last
    three steps down by ``shift`` I, so that Q_uu goes negative there and
    the eigen clamp acts (shifting every step drives V_zz indefinite and
    the recursion to overflow)."""
    import torch
    n = nz + nu
    F_z = np.eye(nz) + 0.1 * rng.standard_normal((B, N, nz, nz))
    F_u = 0.1 * rng.standard_normal((B, N, nz, nu))
    M = rng.standard_normal((B, N, n, n))
    H = M @ np.swapaxes(M, -1, -2) / n + 0.1 * np.eye(n)
    Mt = rng.standard_normal((B, nz, nz))
    L_zz_T = Mt @ np.swapaxes(Mt, -1, -2) / nz + 0.1 * np.eye(nz)
    L_zz = np.concatenate([H[..., :nz, :nz], L_zz_T[:, None]], axis=1)
    L_uz = H[..., nz:, :nz]
    L_uu = H[..., nz:, nz:].copy()
    if indefinite:
        L_uu[:, -3:] -= shift * np.eye(nu)
    L_z = rng.standard_normal((B, N + 1, nz))
    L_u = rng.standard_normal((B, N, nu))
    t = [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
         for a in (F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu)]
    F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu = t
    Z = torch.zeros((B, N + 1, nz), dtype=dtype, device=device)
    L = torch.zeros((B, N + 1), dtype=dtype, device=device)
    return Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu


def cartpole_problem(torch, dtype, device, N, dt=0.05):
    from pddp_tpu_torch.examples.cartpole import (CartpoleCost,
                                                  CartpoleDynamicsModel)
    model = CartpoleDynamicsModel(dt=dt, device=device, dtype=dtype)
    cost = CartpoleCost(device=device, dtype=dtype)
    z0 = torch.tensor([0.0, 0.0, 0.1, 0.0], dtype=dtype, device=device)
    return model, cost, z0


def k2_inputs(rng, B, N, dtype, device):
    """A batch of B nominal cartpole trajectories and the gains of one
    backward pass around the first, perturbed per solve. The pass is
    regularized with reg=10: at this first iterate Q_uu is indefinite and
    reg <= 1 gives non-finite gains."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (backward, local_model,
                                                 rollout)
    from pddp_tpu_torch.encoding import StateEncoding
    enc = StateEncoding.IGNORE_UNCERTAINTY
    model, cost, z0 = cartpole_problem(torch, dtype, device, N)
    U1 = torch.full((N, 1), 0.1, dtype=dtype, device=device)
    Z1, AUX = rollout(model, z0, U1, enc)
    k1, K1, _ = backward(*local_model(Z1, U1, AUX, model, cost, enc),
                         reg=10.0)
    z0s = z0 + torch.as_tensor(0.02 * rng.standard_normal((B, 4)),
                               dtype=dtype, device=device)
    U = U1 + torch.as_tensor(0.05 * rng.standard_normal((B, N, 1)),
                             dtype=dtype, device=device)
    Z, _ = rollout(model, z0s, U, enc)
    noise = lambda shape: torch.as_tensor(  # noqa: E731
        1.0 + 0.01 * rng.standard_normal(shape), dtype=dtype, device=device)
    k = (k1 * noise((B, N, 1))).contiguous()
    K = (K1 * noise((B, N, 1, 4))).contiguous()
    return model, cost, Z.contiguous(), U.contiguous(), k, K


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase0_build(card):
    import torch
    from pddp_tpu_torch.ops import _build
    report = _build.build_all(force=True)
    kernels = {name: ptxas_rows(r["ptxas"]) for name, r in report.items()}
    entries = [r["entry"] for r in kernels["fused_bnn_rollout"]]
    check(all(any("bnn_rollout_kernelI" + t in e for e in entries)
              for t in "fd"), "ptxas reported no K2(d) instance")
    entries = [r["entry"] for r in kernels["fused_particle_rollout"]]
    check(all(any("particle_rollout_kernelI" + t in e for e in entries)
              for t in "fd"), "ptxas reported no K2(e) instance")
    sass = k2d_sass_report(_build._target("fused_bnn_rollout", "f32"))
    emit({"phase": 0, "card": card, "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(max(r["seconds"] for r in report.values()), 3),
          "build_s_per_source": {name: round(r["seconds"], 3)
                                 for name, r in report.items()},
          "k2d_sass": sass, "ptxas": kernels})
    check(len(sass["hmma"]) == 4 and all(v > 0 for v in
                                         sass["hmma"].values()),
          "a float32 bfloat16 instance has no HMMA: {}".format(sass))


def phase1_k1():
    import torch
    from pddp_tpu_torch.controllers.ilqr import backward
    from pddp_tpu_torch.ops import backward_kernel as bk
    # (B, N, nz, nu, indefinite L_uu, reg). The clamp cases take reg=10:
    # the V update runs on the unregularized, negative Q_uu, and at reg=1
    # a third of the seeds drive it to overflow.
    cases = [(1, 200, 4, 1, False, 0.0), (1, 25, 14, 1, False, 0.0),
             (1, 40, 8, 4, False, 0.0), (1024, 200, 4, 1, False, 0.0),
             (1, 40, 8, 4, True, 10.0), (1, 40, 4, 1, True, 10.0)]
    # Every (nz, nu) instance at the B, N of BATCHES, the clamp acting:
    # L_uu of the last steps shifted by 4 I (by 2 I, one single-step
    # solve of six keeps its Q_uu positive).
    old_cases = len(cases)
    cases += [(B, N, nz, nu, True, 10.0) for nz, nu in sorted(bk.INSTANCES)
              for B, N in BATCHES]
    rows = []
    for seed, (B, N, nz, nu, indefinite, reg) in enumerate(cases):
        for dtype in (torch.float32, torch.float64):
            ins = k1_inputs(np.random.default_rng(seed), B, N, nz, nu, dtype,
                            "cuda", indefinite,
                            shift=2.0 if seed < old_cases else 4.0)
            k_p, K_p, ok_p = backward(*ins, reg=reg)
            k_k, K_k, ok_k = bk.kernel_backward(*ins, reg=reg)
            torch.cuda.synchronize()
            dname = str(dtype).replace("torch.", "")
            ek, rk = rel_err(k_k, k_p)
            eK, rK = rel_err(K_k, K_p)
            row = {"B": B, "N": N, "nz": nz, "nu": nu, "dtype": dname,
                   "clamp": indefinite, "reg": reg,
                   "k_abs": ek, "k_rel": rk, "K_abs": eK, "K_rel": rK,
                   "finite": bool(ok_p.all()) and bool(ok_k.all()),
                   "tol": TOL[("K1", dname)]}
            if indefinite:
                # Q_uu of the last step (where V_zz is L_zz's terminal
                # entry): a negative eigenvalue means the clamp acts there.
                F_u, L_zz, L_uu = ins[2], ins[6], ins[8]
                Q_uu = (L_uu[:, -1] + F_u[:, -1].transpose(-1, -2)
                        @ L_zz[:, -1] @ F_u[:, -1])
                row["Q_uu_min_eig_last_step"] = float(
                    torch.linalg.eigvalsh(Q_uu).min())
            row["ok_equal"] = ok_k.tolist() == ok_p.tolist()
            rows.append(row)
    # ok from the kernel on non-finite inputs: a NaN in L_uu of solve 1 and
    # in F_z of solve 3 of five.
    nan_rows = []
    for dtype in (torch.float32, torch.float64):
        ins = k1_inputs(np.random.default_rng(99), 5, 20, 4, 1, dtype, "cuda")
        ins[8][1, 7] = float("nan")
        ins[1][3, 0, 2, 1] = float("nan")
        ok_k = bk.kernel_backward(*ins)[2].tolist()
        ok_p = backward(*ins)[2].tolist()
        nan_rows.append({"dtype": str(dtype).replace("torch.", ""),
                         "ok_kernel": ok_k, "ok_plain": ok_p})
    block_rows, block_nan = phase1_k1_block()
    lane_rows = phase1_k1_lane_regs()
    emit({"phase": 1, "kernel": "K1", "cases": rows, "nan_cases": nan_rows,
          "block_cases": block_rows, "block_nan_cases": block_nan,
          "lane_reg_cases": lane_rows})
    for row in block_nan:
        check(row["ok_kernel"] == row["ok_plain"]
              == [True, False, True, False, True],
              "K1 block kernel's ok on NaN inputs: {}".format(row))
    for row in block_rows:
        check(row["finite"] and row["ok_equal"] and row["launched"],
              "K1 block case gave non-finite gains, another ok or no "
              "launch: {}".format(row))
        check(row["k_rel"] <= row["tol"] and row["K_rel"] <= row["tol"],
              "K1's block kernel disagrees with its plain version: "
              "{}".format(row))
        if row["dtype"] == "float32":
            check(row["plain_float32_rel"] <= K1_BLOCK_F32_CAP
                  and row["kernel_vs_plain_float32_rel"] <= K1_BLOCK_F32_CAP,
                  "K1 block float32 case past K1_BLOCK_F32_CAP: "
                  "{}".format(row))
    for row in nan_rows:
        check(row["ok_kernel"] == row["ok_plain"]
              == [True, False, True, False, True],
              "K1's ok on NaN inputs: {}".format(row))
    for row in rows:
        check(row["finite"] and row["ok_equal"],
              "K1 case gave non-finite gains or another ok: {}".format(row))
        check(row["k_rel"] <= row["tol"] and row["K_rel"] <= row["tol"],
              "K1 disagrees with its plain version: {}".format(row))
        check(row.get("Q_uu_min_eig_last_step", -1.0) < 0,
              "the clamp case has a positive definite Q_uu: {}".format(row))


def phase1_k1_block():
    """K1's block kernel against backward at every shape of
    K1_BLOCK_SHAPES and B, N of BATCHES, in float64 and float32, with the
    library's plan, at K1_SCRATCH_SHAPE in float64 (its workspace past
    shared memory), and at K1_BLOCK_FORCED with the cluster asked there
    (every nu then runs both with and without a cluster), the clamp acting
    in the last steps (L_uu shifted by 4 I, reg=10); float32
    is held against the float64 plain version within the larger of
    K1_BLOCK_TOL and twice the float32 plain version's own error, which
    K1_BLOCK_F32_CAP bounds. Then ok on NaN inputs at nz = 27."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import backward
    from pddp_tpu_torch.ops import backward_kernel as bk
    rows = []
    both = ("float64", "float32")
    shapes = [(nz, nu, both) for nz, nu in K1_BLOCK_SHAPES]
    shapes.append(K1_SCRATCH_SHAPE + (("float64",),))
    for si, (nz, nu, dtypes) in enumerate(shapes):
        # The library's plan, then each cluster K1_BLOCK_FORCED asks for at
        # this shape, on the same inputs and references.
        clusters = [None] + [c for z, u, c in K1_BLOCK_FORCED
                             if (z, u) == (nz, nu)]
        for bi, (B, N) in enumerate(BATCHES):
            seed = 1000 + 10 * si + bi
            ins64 = k1_inputs(np.random.default_rng(seed), B, N, nz, nu,
                              torch.float64, "cuda", True, shift=4.0)
            k64, K64, ok64 = backward(*ins64, reg=10.0)
            for dname in dtypes:
                dtype = getattr(torch, dname)
                ins = [t.to(dtype) for t in ins64]
                tol0 = k1_block_tol(dname, nu)
                if dname == "float32":
                    k_p, K_p, ok_p = backward(*ins, reg=10.0)
                    plain = max(rel_err(k_p.double(), k64)[1],
                                rel_err(K_p.double(), K64)[1])
                    tol0 = max(tol0, 2.0 * plain)
                for cluster in clusters:
                    plan = bk.launch_plan(nz, nu, dtype, B, _cluster=cluster)
                    n = bk.block_launches
                    k_k, K_k, ok_k = bk.kernel_backward(*ins, reg=10.0,
                                                        _cluster=cluster)
                    torch.cuda.synchronize()
                    row = {"B": B, "N": N, "nz": nz, "nu": nu,
                           "dtype": dname, "cluster_asked": cluster,
                           "cluster": plan["cluster"], "tile": plan["tile"],
                           "threads": plan["threads"],
                           "scratch_elems": plan["scratch_elems"],
                           "launched": bk.block_launches == n + 1,
                           "ok_equal": ok_k.tolist() == ok64.tolist()}
                    ek, rk = rel_err(k_k.double(), k64)
                    eK, rK = rel_err(K_k.double(), K64)
                    row.update(k_abs=ek, k_rel=rk, K_abs=eK, K_rel=rK)
                    if dname == "float32":
                        row["plain_float32_rel"] = plain
                        row["kernel_vs_plain_float32_rel"] = max(
                            rel_err(k_k, k_p)[1], rel_err(K_k, K_p)[1])
                    row["tol"] = tol0
                    row["finite"] = bool(ok_k.all()) and bool(ok64.all())
                    rows.append(row)
    check(any(r["scratch_elems"] > 0 for r in rows)
          and all((r["scratch_elems"] > 0) == ((r["nz"], r["nu"])
                                               == K1_SCRATCH_SHAPE)
                  for r in rows),
          "only K1_SCRATCH_SHAPE runs on the scratch buffer")
    for nu in range(1, 5):
        plans = {r["cluster"] > 1 for r in rows if r["nu"] == nu}
        check(plans == {False, True}, "nu={}: K1's block kernel ran only "
              "with cluster > 1 = {}".format(nu, plans))
    nan_rows = []
    for dtype in (torch.float32, torch.float64):
        ins = k1_inputs(np.random.default_rng(98), 5, 20, 27, 1, dtype,
                        "cuda")
        ins[8][1, 7] = float("nan")
        ins[1][3, 0, 2, 1] = float("nan")
        nan_rows.append({"dtype": str(dtype).replace("torch.", ""),
                         "ok_kernel": bk.kernel_backward(*ins)[2].tolist(),
                         "ok_plain": backward(*ins)[2].tolist()})
    return rows, nan_rows


# K1 with a reg per solve (the batched solve's per-lane mu): (nz, nu) of
# the warp kernel at the main path's shape and its Jacobi clamp (8, 4), and
# of the block kernel at nz = 20; BATCHES' full batch (64 lanes, N=25;
# N=100 until phase 21 needed the time, N=200 until phase 19), regs
# 10^U(-6, 2).
K1_LANE_REG_SHAPES = [(4, 1), (8, 4), (20, 1)]


def phase1_k1_lane_regs():
    """K1 at K1_LANE_REG_SHAPES with a reg per lane against the plain
    backward's broadcast of the same (B,) reg, in float64 and float32 under
    phase 1's tolerances (the warp kernel's TOL against the plain version
    of its type; the block kernel's K1_BLOCK_TOL against float64, widened
    to twice the float32 plain version's own error within
    K1_BLOCK_F32_CAP); and three lanes each the bits of a launch where
    every lane takes that lane's reg as a float."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import backward
    from pddp_tpu_torch.ops import backward_kernel as bk
    rows = []
    B, N = BATCHES[-1]
    for si, (nz, nu) in enumerate(K1_LANE_REG_SHAPES):
        rng = np.random.default_rng(2000 + si)
        ins64 = k1_inputs(rng, B, N, nz, nu, torch.float64, "cuda")
        regs64 = torch.as_tensor(10.0**rng.uniform(-6.0, 2.0, B),
                                 device="cuda")
        k64, K64, ok64 = backward(*ins64, reg=regs64)
        block = (nz, nu) not in bk.INSTANCES
        for dname in ("float64", "float32"):
            dtype = getattr(torch, dname)
            ins, regs = [t.to(dtype) for t in ins64], regs64.to(dtype)
            k_p, K_p, ok_p = backward(*ins, reg=regs)
            n = bk.launches + bk.block_launches
            k_k, K_k, ok_k = bk.kernel_backward(*ins, reg=regs)
            torch.cuda.synchronize()
            row = {"B": B, "N": N, "nz": nz, "nu": nu, "dtype": dname,
                   "kernel": "block" if block else "warp",
                   "reg_min": float(regs64.min()),
                   "reg_max": float(regs64.max()),
                   "launched": bk.launches + bk.block_launches == n + 1,
                   "ok_equal": ok_k.tolist() == ok_p.tolist(),
                   "finite": bool(ok_k.all()) and bool(ok_p.all())}
            if block:
                tol = k1_block_tol(dname, nu)
                ref = (k64, K64)
                if dname == "float32":
                    plain = max(rel_err(k_p.double(), k64)[1],
                                rel_err(K_p.double(), K64)[1])
                    row["plain_float32_rel"] = plain
                    row["kernel_vs_plain_float32_rel"] = max(
                        rel_err(k_k, k_p)[1], rel_err(K_k, K_p)[1])
                    tol = max(tol, 2.0 * plain)
            else:
                tol, ref = TOL[("K1", dname)], (k_p, K_p)
            row["k_rel"] = rel_err(k_k.to(ref[0].dtype), ref[0])[1]
            row["K_rel"] = rel_err(K_k.to(ref[1].dtype), ref[1])[1]
            row["tol"] = tol
            row["lanes_as_floats"] = True
            for b in (0, 31, 63):
                k1, K1, _ = bk.kernel_backward(*ins, reg=float(regs[b]))
                row["lanes_as_floats"] &= (torch.equal(k1[b], k_k[b])
                                           and torch.equal(K1[b], K_k[b]))
            rows.append(row)
    for row in rows:
        check(row["launched"] and row["ok_equal"] and row["finite"]
              and row["lanes_as_floats"],
              "K1 with a reg per lane: no launch, another ok, non-finite "
              "gains or a lane off its float launch: {}".format(row))
        check(row["k_rel"] <= row["tol"] and row["K_rel"] <= row["tol"],
              "K1 with a reg per lane disagrees with its plain version: "
              "{}".format(row))
        if "plain_float32_rel" in row:
            check(row["plain_float32_rel"] <= K1_BLOCK_F32_CAP
                  and row["kernel_vs_plain_float32_rel"] <= K1_BLOCK_F32_CAP,
                  "K1 block float32 lane-reg case past K1_BLOCK_F32_CAP: "
                  "{}".format(row))
    return rows


def phase2_k2():
    import torch
    from pddp_tpu_torch.controllers.ilqr import control_law
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    enc = StateEncoding.IGNORE_UNCERTAINTY
    rows = []
    # (B, N, A): ten candidates, and more than a warp's 32 lanes (a warp
    # per 32 candidates of a solve).
    cases = ([(B, N, 10) for B, N in [(1, 200), (1024, 200)] + BATCHES]
             + [(1, 200, 40), (3, 37, 64)])
    for seed, (B, N, A) in enumerate(cases):
        for dtype in (torch.float32, torch.float64):
            model, cost, Z, U, k, K = k2_inputs(np.random.default_rng(seed),
                                                B, N, dtype, "cuda")
            alphas = torch.as_tensor(
                1.025**(-np.arange(10.0)**2) if A == 10
                else np.logspace(0.0, -3.0, A), dtype=dtype, device="cuda")
            for bounded in (False, True):
                b = ((torch.tensor([-0.1], dtype=dtype, device="cuda"),
                      torch.tensor([0.1], dtype=dtype, device="cuda"))
                     if bounded else (None, None))
                plain = control_law(model, Z, U, k, K, alphas, enc,
                                    u_min=b[0], u_max=b[1], cost=cost,
                                    cost_in_scan=True)
                kern = fr.fused_control_law(model, Z, U, k, K, alphas, enc,
                                            cost=cost, u_min=b[0],
                                            u_max=b[1])
                torch.cuda.synchronize()
                dname = str(dtype).replace("torch.", "")
                row = {"B": B, "N": N, "A": A, "dtype": dname,
                       "bounds": bounded, "tol": TOL[("K2", dname)],
                       "finite": all(bool(torch.isfinite(p).all())
                                     for p in plain)}
                for name, a, p in zip("ZUJ", kern, plain):
                    row[name + "_abs"], row[name + "_rel"] = rel_err(a, p)
                rows.append(row)
    emit({"phase": 2, "kernel": "K2", "cases": rows})
    for row in rows:
        check(row["finite"], "plain K2 went non-finite: {}".format(row))
        check(all(row[n + "_rel"] <= row["tol"] for n in "ZUJ"),
              "K2 disagrees with its plain version: {}".format(row))


def golden_solve(dtype):
    import torch
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.convert import golden_cartpole_U0
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_rollout as fr
    model, cost, z0 = cartpole_problem(torch, dtype, "cuda", 60)
    U0 = torch.as_tensor(golden_cartpole_U0(), dtype=dtype, device="cuda")
    opts = ILQROptions(n_iterations=40, riccati_mode="kernel",
                       fused_rollout=True)
    n1, n2 = bk.launches, fr.launches["a"]
    t0 = time.perf_counter()
    r = solve(model, cost, z0, U0, opts,
              encoding=StateEncoding.IGNORE_UNCERTAINTY)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return r, bk.launches - n1, fr.launches["a"] - n2, seconds


def phase3_golden_f64():
    import torch
    from pddp_tpu_torch.controllers.ilqr import iLQRState
    g = np.load(GOLDEN)
    r, l1, l2, sec = golden_solve(torch.float64)
    Z, U = r.Z.cpu().numpy(), r.U.cpu().numpy()
    np.testing.assert_allclose(r.J_opt, g["cartpole_J"], rtol=1e-6)
    np.testing.assert_allclose(Z, g["cartpole_Z"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(U, g["cartpole_U"], rtol=1e-5, atol=1e-7)
    check(r.state == iLQRState.CONVERGED and r.iterations == 14
          and r.evals == 25, "f64 golden solve: {} after {} iterations, {} "
          "evals".format(r.state.name, r.iterations, r.evals))
    check(l1 == 25 and l2 == 25,
          "f64 golden solve launched K1 {} and K2 {} times".format(l1, l2))
    emit({"phase": 3, "dtype": "float64", "state": r.state.name,
          "iterations": r.iterations, "evals": r.evals,
          "K1_launches": l1, "K2_launches": l2,
          "J_rel": abs(r.J_opt - float(g["cartpole_J"]))
          / float(g["cartpole_J"]),
          "Z_abs": float(np.abs(Z - g["cartpole_Z"]).max()),
          "U_abs": float(np.abs(U - g["cartpole_U"]).max()),
          "solve_s": sec})


def phase4_golden_f32():
    import torch
    from pddp_tpu_torch.controllers.ilqr import iLQRState
    g = np.load(GOLDEN)
    r, l1, l2, sec = golden_solve(torch.float32)
    Z, U = r.Z.cpu().numpy(), r.U.cpu().numpy()
    J_rel = abs(r.J_opt - float(g["cartpole_J"])) / float(g["cartpole_J"])
    Z_abs = float(np.abs(Z - g["cartpole_Z"]).max())
    U_abs = float(np.abs(U - g["cartpole_U"]).max())
    emit({"phase": 4, "dtype": "float32", "state": r.state.name,
          "iterations": r.iterations, "evals": r.evals,
          "K1_launches": l1, "K2_launches": l2, "J_rel": J_rel,
          "Z_abs": Z_abs, "U_abs": U_abs, "solve_s": sec})
    check(J_rel <= 1e-5 and Z_abs <= 1e-2 and U_abs <= 1e-2,
          "f32 golden solve off the golden values")
    check(r.state == iLQRState.CONVERGED and r.iterations == 14
          and r.evals == 25, "f32 golden solve: {} after {} iterations, {} "
          "evals".format(r.state.name, r.iterations, r.evals))
    check(l1 == 25 and l2 == 25, "f32 golden solve launch counts")


def phase5_main_path(card):
    """The bench shape in float32: cartpole dt=0.05, H=200, ten alphas."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions, backward,
                                                 control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout, solve)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_rollout as fr
    enc = StateEncoding.IGNORE_UNCERTAINTY
    dtype, H, A = torch.float32, 200, 10
    model, cost, z0 = cartpole_problem(torch, dtype, "cuda", H)
    U0 = torch.full((H, 1), 0.1, dtype=dtype, device="cuda")
    alphas = default_fit_alphas(dtype, "cuda")
    Z0, AUX0 = rollout(model, z0, U0, enc)

    def iteration(kernels):
        derivs = local_model(Z0, U0, AUX0, model, cost, enc)
        if kernels:
            k, K, ok = bk.kernel_backward(*derivs, reg=0.0)
            Z_b, U_b, J_b = fr.fused_control_law(model, derivs[0], U0, k, K,
                                                 alphas, enc, cost=cost)
        else:
            k, K, ok = backward(*derivs, reg=0.0)
            Z_b, U_b, J_b = control_law(model, derivs[0], U0, k, K, alphas,
                                        enc, cost=cost, cost_in_scan=True)
        amin = torch.argmin(J_b).reshape(1)
        return (Z_b.index_select(1, amin)[:, 0],
                U_b.index_select(1, amin)[:, 0], J_b[amin])

    def full_solve(kernels):
        opts = ILQROptions(n_iterations=50,
                           riccati_mode="kernel" if kernels else "scan",
                           fused_rollout=kernels)
        t0 = time.perf_counter()
        r = solve(model, cost, z0, U0, opts, encoding=enc)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), r

    # The main path, once, with the launch counters from zero.
    bk.launches = 0
    reset_counts(fr.launches)
    ms_first, r_main = full_solve(True)
    counts = {"K1": bk.launches, "K2": fr.launches["a"]}
    check(counts["K1"] >= 1 and counts["K2"] >= 1,
          "the main path did not launch every kernel: {}".format(counts))
    check(counts["K1"] == r_main.evals and counts["K2"] == r_main.evals,
          "launches {} differ from the solve's {} evaluations".format(
              counts, r_main.evals))
    check(tuple(r_main.Z.shape) == (H + 1, 4)
          and tuple(r_main.U.shape) == (H, 1)
          and bool(torch.isfinite(r_main.Z).all())
          and bool(torch.isfinite(r_main.U).all())
          and np.isfinite(r_main.J_opt), "main-path solve output")

    # Each kernel against its plain version at inputs the main path gives
    # it: the local model of the solve's result, with the solve's last
    # regularization doubled until the gains are finite, as the solve's
    # next evaluations would escalate it (at the first iterate, and at
    # this one with reg=mu, Q_uu is indefinite and the gains overflow).
    derivs = local_model(r_main.Z, r_main.U, (), model, cost, enc)
    Z_n, U_n = derivs[0], r_main.U
    reg = max(r_main.mu, 1e-6)
    for _ in range(64):
        k_p, K_p, ok_p = backward(*derivs, reg=reg)
        if bool(ok_p):
            break
        reg *= 2.0
    k_k, K_k, ok_k = bk.kernel_backward(*derivs, reg=reg)
    plain2 = control_law(model, Z_n, U_n, k_p, K_p, alphas, enc,
                         cost=cost, cost_in_scan=True)
    kern2 = fr.fused_control_law(model, Z_n, U_n, k_p, K_p, alphas, enc,
                                 cost=cost)
    check(bool(ok_p) and bool(ok_k)
          and all(bool(torch.isfinite(t).all()) for t in plain2),
          "non-finite values at the main path's inputs (reg={})".format(reg))
    k1_err = max(rel_err(k_k, k_p)[0], rel_err(K_k, K_p)[0])
    k1_rel = max(rel_err(k_k, k_p)[1], rel_err(K_k, K_p)[1])
    k2_err = max(rel_err(a, b)[0] for a, b in zip(kern2, plain2))
    k2_rel = max(rel_err(a, b)[1] for a, b in zip(kern2, plain2))
    check(k1_rel <= TOL[("K1", "float32")] and k2_rel <= TOL[("K2",
                                                              "float32")],
          "kernels disagree with plain at the main path's inputs: K1 {} K2 "
          "{}".format(k1_rel, k2_rel))

    # Kernel times at the main-path shape: the kernel alone, the wrapper
    # around it (checks, allocation, finiteness), and the plain versions.
    t = {
        "K1_ms": events_ms(raw_k1(derivs, reg), 200),
        "K1_wrapper_ms": events_ms(
            lambda: bk.kernel_backward(*derivs, reg=reg), 200),
        "K1_plain_ms": events_ms(lambda: backward(*derivs, reg=reg), 20),
        "K2_ms": events_ms(raw_k2(model, cost, Z_n, U_n, k_p, K_p, alphas),
                           200),
        "K2_wrapper_ms": events_ms(lambda: fr.fused_control_law(
            model, Z_n, U_n, k_p, K_p, alphas, enc, cost=cost), 200),
        "K2_plain_ms": events_ms(lambda: control_law(
            model, Z_n, U_n, k_p, K_p, alphas, enc, cost=cost,
            cost_in_scan=True), 20),
    }

    # End-to-end metrics, kernels and plain versions in turns (one each:
    # the plain full solve takes ~25 s, and the two differ ~35x).
    turns = {"kernels": {"iteration_ms": [], "full_solve_ms": [ms_first]},
             "plain": {"iteration_ms": [], "full_solve_ms": []}}
    evals = {"kernels": r_main.evals}
    for kernels in TURNS:
        key = "kernels" if kernels else "plain"
        # The plain iteration takes ~0.3 s: ten of them make its mean.
        turns[key]["iteration_ms"].append(events_ms(
            lambda: iteration(kernels), 50 if kernels else 10,
            warmup=5 if kernels else 1))
        ms, r = full_solve(kernels)
        turns[key]["full_solve_ms"].append(ms)
        evals[key] = r.evals
    # Where the time goes: one iteration and one solve under the profiler.
    profiles = {"iteration": device_profile(lambda: iteration(True)),
                "full_solve": device_profile(lambda: full_solve(True))}
    res = {"phase": 5, "card": card, "dtype": "float32", "H": H, "A": A,
           "profile": profiles,
           "main_path_launches": counts,
           "main_path": {"state": r_main.state.name,
                         "iterations": r_main.iterations,
                         "evals": r_main.evals, "J": r_main.J_opt},
           "evals": evals, "max_abs_err": {"K1": k1_err, "K2": k2_err},
           "max_rel_err": {"K1": k1_rel, "K2": k2_rel},
           "kernel_inputs_reg": reg}
    res.update(t)
    for key, v in turns.items():
        res["ddp_iteration_ms_cartpole_h200_" + key] = min(v["iteration_ms"])
        res["full_solve_ms_50iter_h200_" + key] = min(v["full_solve_ms"])
        res["turns_" + key] = v
    emit(res)
    # Phase 13's inputs: the solve's end, and its first iteration (the
    # local model of U0 and K1's gains at reg=0, as ``iteration`` runs).
    derivs0 = local_model(Z0, U0, AUX0, model, cost, enc)
    k0, K0, _ = bk.kernel_backward(*derivs0, reg=0.0)
    inputs = {"ex": "cartpole", "model": model, "cost": cost, "enc": enc,
              "derivs": derivs, "reg": reg, "Z": Z_n, "U": U_n, "k": k_p,
              "K": K_p, "first": (derivs0[0], U0, k0, K0)}
    return res, inputs


# ---------------------------------------------------------------------------
# The belief-state BNN path: K2 stage (d) and its fragment entries
# ---------------------------------------------------------------------------

TRAINED = os.path.join(ROOT, "tests", "golden", "trained_bnn_cartpole.npz")
BNN_JITTER = (1e-12, 1e-6)
# K2(d) and F1-F3 against their plain versions, relative to the largest
# value of each output. float64: the same arithmetic in another order of
# sums. float32: over one or two steps; at N=25 the candidates' J within
# 1e-3 (the trajectories amplify the f32 rounding, and the best J values
# sit within 2e-4 of each other).
BNN_TOL = {"float64": 1e-10, "float32": 1e-4, "float32_J_N25": 1e-3,
           "F_float32": 1e-5}


def bnn_model(torch, dtype, N, trained, P=100, hidden=(200, 200),
              device="cuda", **network_kwargs):
    """The bench.py:280 configuration: 4 states, 1 action, net 6-200-200-8,
    100 particles, horizon N + 1, the 2-rung ladder; the trained cartpole
    weights or an untrained net from seed 0 (of another particle count P
    or hidden widths where given; ``network_kwargs`` the net's
    ``compute_dtype`` or ``matmul_dtype``)."""
    from pddp_tpu_torch.models.bnn import (bnn_dynamics_model_factory,
                                           load_bnn_npz)
    cls = bnn_dynamics_model_factory(4, 1, list(hidden), angular_indices=(2,),
                                     non_angular_indices=(0, 1, 3),
                                     **network_kwargs)
    model = cls.init(seed=0, n_particles=P, horizon=N + 1, dtype=dtype,
                     device=device, chol_jitter=BNN_JITTER)
    return load_bnn_npz(model, TRAINED) if trained else model


def bnn_start(torch, dtype, N):
    from pddp_tpu_torch.encoding import StateEncoding, encode
    z0 = encode(torch.zeros(4, dtype=dtype, device="cuda"),
                V=1e-2 * torch.ones(4, dtype=dtype, device="cuda"),
                encoding=StateEncoding.UPPER_TRIANGULAR_CHOLESKY)
    return z0, torch.full((N, 1), 0.1, dtype=dtype, device="cuda")


def bnn_inputs(torch, dtype, N, trained, B, rng, P=100, hidden=(200, 200)):
    """Model, cost and (Z, U, k, K) of one reg=1 backward pass around the
    rollout of U = 0.1; for B > 1 the gains are perturbed per solve."""
    from pddp_tpu_torch.controllers.ilqr import backward, local_model, rollout
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    model = bnn_model(torch, dtype, N, trained, P, hidden)
    cost = CartpoleCost(device="cuda", dtype=dtype)
    z0, U = bnn_start(torch, dtype, N)
    Z, AUX = rollout(model, z0, U, ch)
    k, K, ok = backward(*local_model(Z, U, AUX, model, cost, ch), reg=1.0)
    check(bool(ok), "non-finite gains at the BNN inputs")
    if B == 1:
        return model, cost, (Z, U, k, K)

    def noise(t):
        return t * torch.as_tensor(
            1.0 + 0.01 * rng.standard_normal((B,) + tuple(t.shape)),
            dtype=dtype, device="cuda")
    return model, cost, (Z.expand((B,) + Z.shape).contiguous(),
                         U.expand((B,) + U.shape).contiguous(),
                         noise(k).contiguous(), noise(K).contiguous())


def fragment_inputs(torch, model, dtype, G, rng, singular=False):
    """F1-F3 inputs at the main path's shapes: G groups of P particles."""
    n, P = 4, model.n_particles

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    Uc = t(np.triu(0.3 * rng.standard_normal((G, n, n)))
           + 0.5 * np.eye(n))
    if singular:
        Uc[G // 2, 2, 2] = 0.0
    D = t(rng.standard_normal((G, P, n)))
    eps0 = model.eps_in[1].contiguous()
    particles = t(0.1 * rng.standard_normal((G, P, n)))
    x = t(rng.standard_normal((G, P, 6)))
    return Uc, D, eps0, particles, x


def fragment_errors(torch, model, ins, first):
    """Max abs and relative errors of F1, F2, F3 against their plain
    versions on the same inputs."""
    from pddp_tpu_torch.models.bnn import infer_eps
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    Uc, D, eps0, particles, x = ins
    F1 = rel_err(fb.infer_eps(Uc, D, eps0, first),
                 infer_eps(Uc, D, eps0, first))
    z_k, U_k = fb.moment_match(particles, BNN_JITTER)
    z_p, U_p = fb.moment_match(particles.cpu(), BNN_JITTER)
    F2 = max(rel_err(z_k.cpu(), z_p), rel_err(U_k.cpu(), U_p))
    F3 = rel_err(fb.mlp(model.net, x), model.net(x))
    torch.cuda.synchronize()
    return {"F1": F1, "F2": F2, "F3": F3}


# K2(d) cases that exercise the split of the particles over a cluster,
# two steps each (untrained nets): (P, hidden widths, A, B, bounded). P=37
# is no multiple of the particles a CTA; A=40 is more candidates than the
# 32 lanes of K2(a)-(c) (each candidate is its own cluster here); B=3 and
# B=64 change the planned cluster size; the bounds clamp u.
K2D_SPLIT_CASES = ((37, (32, 32), 10, 1, False),
                   (37, (32, 32), 40, 3, False),
                   (37, (32, 32), 10, 3, True),
                   (100, (200, 200), 40, 1, False),
                   (100, (200, 200), 10, 3, True),
                   (100, (200, 200), 10, 64, True))
K2D_BOUNDS = (-0.05, 0.05)


def k2d_split_case(torch, dtype, P, hidden, A, B, bounded):
    """K2(d) against control_law at one K2D_SPLIT_CASES entry; the row
    carries the launch plan."""
    from pddp_tpu_torch.controllers.ilqr import control_law
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    N, dname = 2, str(dtype).replace("torch.", "")
    model, _, ins = bnn_inputs(torch, dtype, N, False, B,
                               np.random.default_rng(P + A + B), P, hidden)
    alphas = torch.logspace(0.0, -3.0, A, dtype=dtype, device="cuda")
    lo, hi = (torch.tensor([v], dtype=dtype, device="cuda")
              for v in K2D_BOUNDS) if bounded else (None, None)
    kern = fb.fused_bnn_control_law(model, *ins, alphas, ch, u_min=lo,
                                    u_max=hi)
    plain = control_law(model, *ins, alphas, ch, u_min=lo, u_max=hi,
                        with_aux=True)
    torch.cuda.synchronize()
    row = {"dtype": dname, "N": N, "B": B, "A": A, "P": P,
           "widths": [6, *hidden, 8], "bounded": bounded, "trained": False,
           "plan": fb.launch_plan(model, B * A, dtype, ch),
           "finite": all(bool(torch.isfinite(p).all()) for p in plain),
           "tol": BNN_TOL[dname]}
    for name, a, p in zip(("Z", "U", "AUX"), kern, plain):
        row[name + "_abs"], row[name + "_rel"] = rel_err(a, p)
    return row


def phase7_bnn_kernels():
    """K2(d), F1, F2 and F3 against their plain versions on the card."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (control_law,
                                                 default_fit_alphas,
                                                 trajectory_cost)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    rows, frags = [], []
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        alphas = default_fit_alphas(dtype, "cuda")
        for N, trained in ((1, False), (2, False), (25, True)):
            for B in (1, 64):
                rng = np.random.default_rng(7 * N + B)
                model, cost, ins = bnn_inputs(torch, dtype, N, trained, B,
                                              rng)
                kern = fb.fused_bnn_control_law(model, *ins, alphas, ch)
                plain = control_law(model, *ins, alphas, ch, with_aux=True)
                J_k = trajectory_cost(cost, kern[0], kern[1], ch)
                J_p = trajectory_cost(cost, plain[0], plain[1], ch)
                torch.cuda.synchronize()
                row = {"dtype": dname, "N": N, "B": B, "trained": trained,
                       "finite": all(bool(torch.isfinite(p).all())
                                     for p in plain)}
                for name, a, p in zip(("Z", "U", "AUX"), kern, plain):
                    row[name + "_abs"], row[name + "_rel"] = rel_err(a, p)
                J_rel = ((J_k - J_p).abs() / J_p.abs()).max()
                row["J_rel_max_over_candidates"] = float(J_rel)
                row["tol"] = (BNN_TOL["float32_J_N25"]
                              if dname == "float32" and N > 2
                              else BNN_TOL[dname])
                rows.append(row)
        rows += [k2d_split_case(torch, dtype, *case)
                 for case in K2D_SPLIT_CASES]
        model = bnn_model(torch, dtype, 2, False)
        for G, singular, first in ((10, False, False), (10, True, False),
                                   (10, False, True), (640, False, False)):
            ins = fragment_inputs(torch, model, dtype, G,
                                  np.random.default_rng(G), singular)
            err = fragment_errors(torch, model, ins, first)
            frags.append({"dtype": dname, "G": G, "P": model.n_particles,
                          "F1_fallback_group": singular, "first": first,
                          **{k: {"abs": v[0], "rel": v[1]}
                             for k, v in err.items()},
                          "tol": BNN_TOL[dname if dname == "float64"
                                         else "F_float32"]})
    emit({"phase": 7, "kernel": "K2(d) F1 F2 F3", "K2d_cases": rows,
          "fragment_cases": frags})
    for row in rows:
        check(row["finite"], "plain BNN rollout went non-finite: {}".format(
            row))
        if row["dtype"] == "float32" and row["N"] > 2:
            check(row["J_rel_max_over_candidates"] <= row["tol"],
                  "K2(d) f32 J off its plain version: {}".format(row))
        else:
            check(all(row[n + "_rel"] <= row["tol"]
                      for n in ("Z", "U", "AUX")),
                  "K2(d) disagrees with its plain version: {}".format(row))
    for f in frags:
        check(all(f[k]["rel"] <= f["tol"] for k in ("F1", "F2", "F3")),
              "a fragment disagrees with its plain version: {}".format(f))
    return rows, frags


def raw_bnn(torch, entry, model, dtype, args, enc=None):
    """A closure launching one BNN entry alone on preallocated outputs
    (K2(d) under the codec ``enc``, by default the Cholesky codec)."""
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    fn = fb._function(entry, dtype)
    stream = torch.cuda.current_stream().cuda_stream
    if entry == "rollout":
        Z, U, k, K, alphas = args
        params, cfg = fb._params(
            model, dtype, "cuda",
            StateEncoding.UPPER_TRIANGULAR_CHOLESKY if enc is None else enc)
        B, N, A, nz = U.shape[0], U.shape[1], alphas.shape[0], Z.shape[-1]
        outs = [torch.empty(s, dtype=dtype, device="cuda") for s in
                ((B, N + 1, A, nz), (B, N, A, 1), (B, N, A, 100, 4))]
        eps_in = model.eps_in.contiguous()
        ptrs = ([t.data_ptr() for t in (Z, U, k, K, alphas, params, eps_in)]
                + [None, None] + [o.data_ptr() for o in outs]
                + [B, N, A, cfg, stream])
    elif entry == "infer_eps":
        Uc, D, eps0 = args
        out = torch.empty_like(D)
        ptrs = [Uc.data_ptr(), D.data_ptr(), eps0.data_ptr(), 0,
                out.data_ptr(), D.shape[0],
                fb._config_ints({"n": 4, "P": D.shape[1]}), stream]
    elif entry == "moment_match":
        (particles,) = args
        pk = fb._Packer(dtype, "cuda")
        pk.jitter(BNN_JITTER)
        pk.cfg.update(n=4, P=particles.shape[1])
        params, cfg = pk.done()
        G = particles.shape[0]
        outs = [torch.empty(s, dtype=dtype, device="cuda")
                for s in ((G, 14), (G, 4, 4))]
        ptrs = [particles.data_ptr(), params.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), G, cfg, stream]
    else:
        (x,) = args
        pk = fb._Packer(dtype, "cuda")
        pk.net(model.net, x.shape[1], 4)
        params, cfg = pk.done()
        y = torch.empty(x.shape[:2] + (8,), dtype=dtype, device="cuda")
        ptrs = [x.data_ptr(), params.data_ptr(), y.data_ptr(), x.shape[0],
                cfg, stream]

    def launch():
        check(fn(*ptrs) == 0, "{} launch".format(entry))
    return launch


def bnn_work(model, B, N, A, G, itemsize, codec=1):
    """(bytes, operations) of K2(d), F1, F2 and F3 at these shapes, each
    input read once and each output written once; a multiply-add counts
    2, a sine, exponential, square root or division 1. K2(d) under codec
    ``codec`` (StateEncoding's value; the Cholesky codec's by default):
    its state's size, and the moment match's covariance (FULL, CHOL),
    variances (VAR, STD) or neither (IGNORE); the Cholesky factor's work
    (CHOL's encode, FULL's decode) is the same one count in each."""
    n, nu, P = 4, 1, model.n_particles
    nz = {0: n + n * n, 1: n + n * (n + 1) // 2, 2: 2 * n, 3: 2 * n,
          4: n}[codec]
    widths = [6, 200, 200, 8]
    weights = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    masks = P * sum(widths[1:-1])
    mlp = P * (2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
               + sum(widths[1:]) + 2 * sum(widths[1:-1]))
    infer = P * (n + n * (n - 1) + n)
    moments = P * n * 2 + P * n * (n + 1) // 2 * 3 + 2 * (n**3 // 3 + 2 * n)
    moments_codec = {0: moments, 1: moments,
                     2: P * n * 2 + P * n * 3 + n, 3: P * n * 2 + P * n * 3 + n,
                     4: P * n * 2}[codec]
    step = (2 * nz + 3 + infer + 2 * P * n * n + P * 6 * 2 + mlp
            + P * n * 3 + moments_codec)
    k2_bytes = (B * ((N + 1) * nz + 3 * N + N * nz) + A + weights + masks
                + 20 + N * P * n + B * ((N + 1) * A * nz + N * A
                                        + N * A * P * n)) * itemsize
    return {
        "K2(d)": (k2_bytes, B * A * N * step),
        "F1": ((G * n * n + 2 * G * P * n + P * n) * itemsize, G * infer),
        "F2": ((G * P * n + G * nz + G * n * n) * itemsize, G * moments),
        "F3": ((G * P * 6 + weights + masks + G * P * 8) * itemsize,
               G * mlp),
    }


def phase8_bnn_iteration(card):
    """Iteration (i) at full width in float32: local model, K1 at nz=14,
    K2(d), the batched cost post-pass and the masked argmin, through the
    kernels and through the plain versions in alternating turns."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (backward, control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout,
                                                 trajectory_cost)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    from pddp_tpu_torch.ops import fused_rollout as fr
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    dtype, N, A, reg = torch.float32, 25, 10, 1.0
    model = bnn_model(torch, dtype, N, True)
    cost = CartpoleCost(device="cuda", dtype=dtype)
    z0, U0 = bnn_start(torch, dtype, N)
    alphas = default_fit_alphas(dtype, "cuda")
    Z0, AUX0 = rollout(model, z0, U0, ch)

    def line_search(kernels, derivs):
        if kernels:
            k, K, ok = bk.kernel_backward(*derivs, reg=reg)
            Z_b, U_b, AUX_b = fr.fused_control_law(
                model, derivs[0], U0, k, K, alphas, ch, with_aux=True)
        else:
            k, K, ok = backward(*derivs, reg=reg)
            Z_b, U_b, AUX_b = control_law(model, derivs[0], U0, k, K,
                                          alphas, ch, with_aux=True)
        return Z_b, U_b, AUX_b, trajectory_cost(cost, Z_b, U_b, ch)

    def iteration(kernels):
        derivs = local_model(Z0, U0, AUX0, model, cost, ch)
        Z_b, U_b, AUX_b, J_b = line_search(kernels, derivs)
        amin = torch.argmin(torch.where(torch.isfinite(J_b), J_b,
                                        torch.inf)).reshape(1)
        return (Z_b.index_select(1, amin)[:, 0],
                U_b.index_select(1, amin)[:, 0],
                AUX_b.index_select(1, amin)[:, 0], J_b[amin])

    # The path, once, with every count from zero.
    bk.launches = 0
    reset_counts(fr.launches)
    reset_counts(fb.launches)
    Z_w, U_w, AUX_w, J_w = iteration(True)
    torch.cuda.synchronize()
    counts = {"K1": bk.launches, "K2(a)": fr.launches["a"],
              **{"K2(d)" if k == "rollout" else
                 {"infer_eps": "F1", "moment_match": "F2", "mlp": "F3"}[k]:
                 v for k, v in fb.launches.items()}}
    check(counts["K1"] == 1 and counts["K2(d)"] == 1,
          "the BNN iteration did not launch K1 and K2(d) once: {}".format(
              counts))
    check(tuple(Z_w.shape) == (N + 1, 14) and tuple(AUX_w.shape)
          == (N, 100, 4) and bool(torch.isfinite(Z_w).all())
          and bool(torch.isfinite(J_w).all()), "BNN iteration output")

    # Both line searches on the same local model and gains: J per
    # candidate and the trajectories' deviation.
    derivs = local_model(Z0, U0, AUX0, model, cost, ch)
    out_k = line_search(True, derivs)
    out_p = line_search(False, derivs)
    torch.cuda.synchronize()
    J_rel = ((out_k[3] - out_p[3]).abs() / out_p[3].abs())
    k2_abs = max(rel_err(a, b)[0] for a, b in zip(out_k[:3], out_p[:3]))
    check(float(J_rel.max()) <= BNN_TOL["float32_J_N25"],
          "K2(d) J off the plain line search: {}".format(J_rel.tolist()))

    # Kernel times at the path's shapes: each entry alone, K2(d)'s
    # wrapper, the plain versions and, for F1, the library's solve.
    k, K, _ = bk.kernel_backward(*derivs, reg=reg)
    rng = np.random.default_rng(8)
    Uc, D, eps0, particles, x = fragment_inputs(torch, model, dtype, A, rng)
    frag_err = fragment_errors(torch, model, (Uc, D, eps0, particles, x),
                               False)
    from pddp_tpu_torch.models.bnn import infer_eps
    from pddp_tpu_torch.models.bnn.model import moment_match
    rollout_args = tuple(t.unsqueeze(0).contiguous()
                         for t in (derivs[0], U0, k, K)) + (alphas,)
    t = {
        "K2(d)_ms": events_ms(raw_bnn(torch, "rollout", model, dtype,
                                      rollout_args), 20),
        "K2(d)_wrapper_ms": events_ms(lambda: fb.fused_bnn_control_law(
            model, derivs[0], U0, k, K, alphas, ch), 20),
        "K2(d)_plain_ms": events_ms(lambda: control_law(
            model, derivs[0], U0, k, K, alphas, ch, with_aux=True), 5),
        "F1_ms": events_ms(raw_bnn(torch, "infer_eps", model, dtype,
                                   (Uc, D, eps0)), 200),
        "F1_plain_ms": events_ms(lambda: infer_eps(Uc, D, eps0, False), 50),
        "F1_library_ms": events_ms(lambda: torch.linalg.solve_triangular(
            Uc, D, upper=True, left=False), 200),
        "F2_ms": events_ms(raw_bnn(torch, "moment_match", model, dtype,
                                   (particles,)), 200),
        "F2_plain_ms": events_ms(lambda: moment_match(
            particles, ch, BNN_JITTER), 50),
        "F3_ms": events_ms(raw_bnn(torch, "mlp", model, dtype, (x,)), 200),
        "F3_plain_ms": events_ms(lambda: model.net(x), 50),
    }

    turns = {"kernels": [], "plain": []}
    for kernels in TURNS:
        turns["kernels" if kernels else "plain"].append(
            events_ms(lambda: iteration(kernels), 5, warmup=1))
    profile = device_profile(lambda: iteration(True))
    res = {"phase": 8, "card": card, "dtype": "float32", "N": N, "A": A,
           "P": 100, "reg": reg, "path_launches": counts,
           "pddp_bnn_iteration_ms_h25_p100_kernels": min(turns["kernels"]),
           "pddp_bnn_iteration_ms_h25_p100_plain": min(turns["plain"]),
           "turns": turns, "profile": profile,
           "J_kernel": out_k[3].tolist(), "J_plain": out_p[3].tolist(),
           "J_rel_per_candidate": J_rel.tolist(),
           "Z_abs_max": rel_err(out_k[0], out_p[0])[0],
           "winner_J": float(J_w), "max_abs_err": {"K2(d)": k2_abs,
                                                   **{k: v[0] for k, v in
                                                      frag_err.items()}}}
    res.update(t)
    emit(res)
    return res, model, {"derivs": derivs, "reg": reg, "model": model,
                        "rollout_args": rollout_args}


def phase9_bnn_solve(card):
    """Solve (ii): 5 iterations, 15 evaluations at most, K1 at nz=14 and
    the scan line search (pddp_tpu's gate keeps the stateful model out of
    K2), float32, full width."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    dtype, N = torch.float32, 25
    model = bnn_model(torch, dtype, N, True)
    cost = CartpoleCost(device="cuda", dtype=dtype)
    z0, U0 = bnn_start(torch, dtype, N)
    opts = ILQROptions(n_iterations=5, max_evals=15, riccati_mode="kernel")
    # One solve: a second one gave the same result to the bit.
    bk.launches = 0
    k2d = fb.launches["rollout"]
    t0 = time.perf_counter()
    r = solve(model, cost, z0, U0, opts,
              encoding=StateEncoding.UPPER_TRIANGULAR_CHOLESKY)
    torch.cuda.synchronize()
    runs = [{"wall_ms": 1e3 * (time.perf_counter() - t0),
             "state": r.state.name, "iterations": r.iterations,
             "evals": r.evals, "J": r.J_opt, "mu": r.mu,
             "K1_launches": bk.launches,
             "K2(d)_launches": fb.launches["rollout"] - k2d}]
    check(r.evals >= 1 and bk.launches == r.evals
          and runs[-1]["K2(d)_launches"] == 0
          and bool(torch.isfinite(r.Z).all())
          and np.isfinite(r.J_opt), "BNN solve: {}".format(runs[-1]))
    emit({"phase": 9, "card": card, "dtype": "float32", "N": N,
          "runs": runs})
    return runs



# ---------------------------------------------------------------------------
# The known-dynamics examples: K2 stages (b) and (c), the golden cases and
# the H=200 paths of pendulum, double cartpole and rendezvous
# ---------------------------------------------------------------------------

# name -> (module, model class, cost class, x0, dt, golden horizon), the
# configurations of tests/golden/cases.py.
EXAMPLES = {
    "cartpole": ("cartpole", "CartpoleDynamicsModel", "CartpoleCost",
                 [0.0, 0.0, 0.1, 0.0], 0.05, 60),
    "pendulum": ("pendulum", "PendulumDynamicsModel", "PendulumCost",
                 [0.0, 0.0], 0.1, 50),
    "double_cartpole": ("double_cartpole", "DoubleCartpoleDynamicsModel",
                        "DoubleCartpoleCost",
                        [0.0, 0.0, 0.05, 0.0, -0.05, 0.0], 0.05, 40),
    "rendezvous": ("rendezvous", "RendezvousDynamicsModel", "RendezvousCost",
                   [-10.0, -10.0, 10.0, 10.0, 0.0, -5.0, 5.0, 0.0], 0.1, 40),
}
# K2(b)/(c) against control_law: f64 the same arithmetic apart from the
# order of sums and fused multiply-adds. float32, phase 1's rule for K1's
# block kernel: each output of the kernel against the float64 plain
# version on the same inputs within the larger of 1e-4 and twice the
# float32 plain version's own distance there (over up to 200 steps the
# float32 recursion itself strays ~1e-4 from float64: 3 of 192 seeds of
# scripts/torch_k2c_seeds.py put the kernel 1.037e-4 off the float32
# plain version while that version was 1.007e-4 off float64).
K2BC_TOL = {"float64": 1e-12, "float32": 1e-4}
# The float32 rule of phases 10 and 19 (f32_derived): the float32 plain
# version's own distance to float64, and the kernel's distance to the
# float32 plain version, must stay under F32_DERIVED_CAP (past it the
# inputs, not the kernel, are at fault), so a derived tolerance cannot
# widen past twice the cap. The largest own distance of either phase is
# 19a's particle rendezvous step noise, 5.6e-3 on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md).
F32_DERIVED_CAP = 1e-2


def f32_derived(kernel_vs_f64, plain_vs_f64, kernel_vs_plain, floor):
    """{"tol", "held"}: a float32 output held within the larger of
    ``floor`` and twice the float32 plain version's own distance to the
    float64 plain version on the same inputs (relative distances)."""
    tol = max(floor, 2.0 * plain_vs_f64)
    return {"tol": tol,
            "held": (kernel_vs_f64 <= tol
                     and plain_vs_f64 <= F32_DERIVED_CAP
                     and kernel_vs_plain <= F32_DERIVED_CAP)}


def example(name, dtype):
    """(model, cost, x0) of example ``name`` on the card."""
    import importlib

    import torch
    mod, model_cls, cost_cls, x0, dt, _ = EXAMPLES[name]
    m = importlib.import_module("pddp_tpu_torch.examples." + mod)
    return (getattr(m, model_cls)(dt=dt, device="cuda", dtype=dtype),
            getattr(m, cost_cls)(device="cuda", dtype=dtype),
            torch.tensor(x0, dtype=dtype, device="cuda"))


def start_state(x0, enc):
    """x0 itself, or under a belief codec encode(x0, C=1e-2 I)."""
    import torch
    from pddp_tpu_torch.encoding import StateEncoding, encode
    if enc == StateEncoding.IGNORE_UNCERTAINTY:
        return x0
    n = x0.shape[-1]
    return encode(x0, C=1e-2 * torch.eye(n, dtype=x0.dtype,
                                         device=x0.device), encoding=enc)


def k2bc_inputs(rng, name, enc, B, N, dtype, first_reg=10.0):
    """As k2_inputs, for example ``name`` under codec ``enc``, in float64
    then cast: the gains of one backward around the rollout of U = 0.1
    under IGNORE_UNCERTAINTY (their belief columns small seeded values),
    perturbed per solve, and B nominal rollouts of perturbed actions
    under ``enc``. The starts are not perturbed: the gains hold the
    candidates near the trajectory they were made for, where the double
    cartpole stays out of its chaotic regime (from starts 0.02 away, its
    closed loop amplifies a rounding difference of 1e-15 to 6e-13 over
    40 steps, in float64 on the CPU). The gains are those of the least
    reg of first_reg, 10 first_reg, ... that makes them finite with
    |K| <= 50; over 200 steps those of reg >= 10 leave the pendulum's
    closed loop unstable (it amplifies a rounding difference some
    1e4-fold), and first_reg=0.1 gives gains that hold it."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (backward, local_model,
                                                 rollout)
    from pddp_tpu_torch.encoding import (StateEncoding,
                                         infer_encoded_state_size)
    ign = StateEncoding.IGNORE_UNCERTAINTY
    f64 = torch.float64
    model, cost, x0 = example(name, f64)
    n, nu = model.state_size, model.action_size
    nz = infer_encoded_state_size(n, enc)

    def t(a):
        return torch.as_tensor(a, dtype=f64, device="cuda")

    U1 = torch.full((N, nu), 0.1, dtype=f64, device="cuda")
    Z1, AUX = rollout(model, x0, U1, ign)
    derivs = local_model(Z1, U1, AUX, model, cost, ign)
    # Finite, moderate gains: at this first iterate Q_uu is indefinite,
    # and the regularization goes up tenfold from 10 until they are.
    for reg in first_reg * 10.0**np.arange(8):
        k1, K1, ok = backward(*derivs, reg=float(reg))
        if bool(ok) and float(K1.abs().max()) <= 50.0:
            break
    check(bool(ok), "non-finite gains at the {} inputs".format(name))
    K1 = torch.cat([K1, t(0.01 * rng.standard_normal((N, nu, nz - n)))], -1)
    Z, _ = rollout(model, start_state(x0.expand(B, n), enc),
                   U1 + t(0.05 * rng.standard_normal((B, N, nu))), enc)
    U = U1 + t(0.05 * rng.standard_normal((B, N, nu)))
    k = k1 * t(1.0 + 0.01 * rng.standard_normal((B, N, nu)))
    K = K1 * t(1.0 + 0.01 * rng.standard_normal((B, N, nu, nz)))
    model, cost, _ = example(name, dtype)
    return model, cost, tuple(a.to(dtype).contiguous() for a in (Z, U, k, K))


def phase10_k2bc():
    """K2 stages (b) and (c) against control_law on the card: every
    example under IGNORE_UNCERTAINTY (stage b; the cartpole's stage (a) is
    phase 2) and under VARIANCE_ONLY, the Cholesky codec and the full
    covariance (stage c), with and without bounds, at B, N = (1, 12) and
    BATCHES, f64 and f32. Each case's inputs are
    made once in float64 and rounded to float32's values, so that both
    types run on the same inputs and the float64 plain version is the
    reference of the float32 check (K2BC_TOL)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import control_law, default_fit_alphas
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    t0 = time.perf_counter()
    codecs = (StateEncoding.IGNORE_UNCERTAINTY, StateEncoding.VARIANCE_ONLY,
              StateEncoding.UPPER_TRIANGULAR_CHOLESKY,
              StateEncoding.FULL_COVARIANCE_MATRIX)
    rows = []
    group = 0
    for name in ("pendulum", "double_cartpole", "rendezvous", "cartpole"):
        for enc in codecs:
            if name == "cartpole" and enc == codecs[0]:
                continue
            # (seed offset, (B, N, bounded)): the offset is the case's
            # place before the full batch at the golden horizon (64, 40-60)
            # went for phase 19's time (BATCHES' (64, 25) is the full
            # batch), so each case keeps the seed its float64 row had.
            for j, (B, N, bounded) in ((0, (1, 12, True)),
                                       (2, BATCHES[0] + (False,)),
                                       (3, BATCHES[1] + (True,)),
                                       (4, BATCHES[2] + (False,))):
                rng = np.random.default_rng(10 * group + j)
                _, _, ins64 = k2bc_inputs(
                    rng, name, enc, B, N, torch.float64,
                    first_reg=0.1 if (B, N) in BATCHES else 10.0)
                ins64 = tuple(a.float().double() for a in ins64)
                ref = None
                for dtype in (torch.float64, torch.float32):
                    dname = str(dtype).replace("torch.", "")
                    alphas = default_fit_alphas(dtype, "cuda")
                    model, cost, _ = example(name, dtype)
                    ins = tuple(a.to(dtype) for a in ins64)
                    nu = model.action_size
                    b = ((torch.full((nu,), -0.12, dtype=dtype,
                                     device="cuda"),
                          torch.full((nu,), 0.12, dtype=dtype,
                                     device="cuda"))
                         if bounded else (None, None))
                    st = fr.stage(model, cost, enc)
                    before = fr.launches[st]
                    kern = fr.fused_control_law(model, *ins, alphas, enc,
                                                cost=cost, u_min=b[0],
                                                u_max=b[1])
                    plain = control_law(model, *ins, alphas, enc,
                                        u_min=b[0], u_max=b[1], cost=cost,
                                        cost_in_scan=enc == codecs[0])
                    torch.cuda.synchronize()
                    row = {"model": name, "codec": enc.name, "stage": st,
                           "dtype": dname, "B": B, "N": N,
                           "bounds": bounded,
                           "launched": fr.launches[st] - before,
                           "finite": all(bool(torch.isfinite(p).all())
                                         for p in plain)}
                    if bounded:
                        row["at_bound_share"] = float(
                            (plain[1].abs() == 0.12).to(torch.float64)
                            .mean())
                    for key, a, p in zip("ZUJ", kern, plain):
                        row[key + "_abs"], row[key + "_rel"] = rel_err(a, p)
                    if ref is None:
                        ref = plain
                        row["tol"] = K2BC_TOL[dname]
                        row["held"] = all(row[key + "_rel"] <= row["tol"]
                                          for key in "ZUJ")
                    else:
                        row["kernel_vs_plain_float32_rel"] = max(
                            row[key + "_rel"] for key in "ZUJ")
                        row["plain_float32_rel"] = max(
                            rel_err(p.double(), r)[1]
                            for p, r in zip(plain, ref))
                        row["kernel_vs_float64_rel"] = max(
                            rel_err(a.double(), r)[1]
                            for a, r in zip(kern, ref))
                        row.update(f32_derived(
                            row["kernel_vs_float64_rel"],
                            row["plain_float32_rel"],
                            row["kernel_vs_plain_float32_rel"],
                            K2BC_TOL[dname]))
                    rows.append(row)
            group += 1
    f32 = [r for r in rows if r["dtype"] == "float32"]
    emit({"phase": 10, "kernel": "K2(b) K2(c)", "cases": rows,
          "float32_plain_rel_max": max(r["plain_float32_rel"] for r in f32),
          "float32_kernel_vs_float64_rel_max": max(
              r["kernel_vs_float64_rel"] for r in f32),
          "float32_tol_max": max(r["tol"] for r in f32),
          "seconds": time.perf_counter() - t0})
    for row in rows:
        check(row["finite"] and row["launched"] == 1,
              "K2(b)/(c) case did not launch or went non-finite: {}".format(
                  row))
        check(row["held"],
              "K2(b)/(c) disagrees with its plain version: {}".format(row))
        check(not row["bounds"] or row["at_bound_share"] > 0,
              "the bounds did not bind: {}".format(row))
    return rows


# The golden cases of tests/golden/cases.py: (example, codec, iterations,
# options, end states), the end states of the JAX solves and of the CPU
# plain ones. Rendezvous is linear-quadratic: its first step reaches the
# optimum, and every later candidate ties its J within an ulp or two, so
# the order of sums decides whether one of them is accepted (CONVERGED
# after 2 iterations and 2 to 11 evaluations; JAX: 2 and 2) or none is
# (MAX_REG after 1 and 11; the port on one CPU thread), with the same J, Z
# and U; any of these ends is accepted.
GOLDEN_CASES = {
    "pendulum": ("pendulum", "IGNORE_UNCERTAINTY", 50, {},
                 [("CONVERGED", 49, 58)]),
    "cartpole": ("cartpole", "IGNORE_UNCERTAINTY", 40, {},
                 [("CONVERGED", 14, 25)]),
    "double_cartpole": ("double_cartpole", "IGNORE_UNCERTAINTY", 25, {},
                        [("ACCEPTED", 25, 52)]),
    "rendezvous": ("rendezvous", "IGNORE_UNCERTAINTY", 25, {},
                   [("MAX_REG", 1, 11)] + [("CONVERGED", 2, e)
                                           for e in range(2, 12)]),
    "pendulum_chol": ("pendulum", "UPPER_TRIANGULAR_CHOLESKY", 25, {},
                      [("ACCEPTED", 25, 36)]),
    "cartpole_boxqp": ("cartpole", "IGNORE_UNCERTAINTY", 40,
                       {"u_min": [-0.75], "u_max": [0.75]},
                       [("CONVERGED", 7, 12)]),
    "pendulum_vzz": ("pendulum", "IGNORE_UNCERTAINTY", 50,
                     {"v_zz_reg": True}, [("CONVERGED", 44, 55)]),
    "pendulum_boxqp_vzz": ("pendulum", "IGNORE_UNCERTAINTY", 50,
                           {"u_min": [-2.0], "u_max": [2.0],
                            "v_zz_reg": True}, [("ACCEPTED", 50, 68)]),
}


def phase11_golden_cases():
    """The eight golden cases in f64 through K1 and K2 against
    tests/golden/solver_trajectories.npz, with the launch counts: K2 on
    every evaluation; K1 on every evaluation of the unconstrained,
    non-v_zz cases and on none of the others (pddp_tpu's gate sends those
    to the scan backward)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.convert import golden_U0
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_rollout as fr
    t0 = time.perf_counter()
    g = np.load(GOLDEN)
    rows = []
    for name, (ex, codec, iters, extra, outcomes) in GOLDEN_CASES.items():
        enc = StateEncoding[codec]
        model, cost, x0 = example(ex, torch.float64)
        U0 = torch.as_tensor(golden_U0(name), device="cuda")
        opts = ILQROptions(n_iterations=iters, riccati_mode="kernel",
                           fused_rollout=True, **extra)
        scan = "u_min" in extra or "v_zz_reg" in extra
        bk.launches = 0
        reset_counts(fr.launches)
        t1 = time.perf_counter()
        r = solve(model, cost, start_state(x0, enc), U0, opts, encoding=enc)
        torch.cuda.synchronize()
        Z, U = r.Z.cpu().numpy(), r.U.cpu().numpy()
        row = {"case": name, "state": r.state.name,
               "iterations": r.iterations, "evals": r.evals,
               "K1_launches": bk.launches, "K2_launches": dict(fr.launches),
               "backward": "scan (pddp_tpu's gate)" if scan else "K1",
               "line_search": "K2({})".format(fr.stage(model, cost, enc)),
               "J_rel": abs(r.J_opt - float(g[name + "_J"]))
               / abs(float(g[name + "_J"])),
               "Z_abs": float(np.abs(Z - g[name + "_Z"]).max()),
               "U_abs": float(np.abs(U - g[name + "_U"]).max()),
               "solve_s": time.perf_counter() - t1}
        rows.append(row)
        np.testing.assert_allclose(r.J_opt, g[name + "_J"], rtol=1e-6)
        np.testing.assert_allclose(Z, g[name + "_Z"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(U, g[name + "_U"], rtol=1e-5, atol=1e-7)
        check((r.state.name, r.iterations, r.evals) in outcomes,
              "golden {} ended {}, expected {}".format(name, row, outcomes))
        check(sum(fr.launches.values()) == r.evals
              and bk.launches == (0 if scan else r.evals),
              "golden {} launch counts: {}".format(name, row))
    emit({"phase": 11, "dtype": "float64", "cases": rows,
          "seconds": time.perf_counter() - t0})
    return rows


# Phase 12's configurations: (label, example, codec).
PATHS = (("pendulum", "pendulum", "IGNORE_UNCERTAINTY"),
         ("double_cartpole", "double_cartpole", "IGNORE_UNCERTAINTY"),
         ("rendezvous", "rendezvous", "IGNORE_UNCERTAINTY"),
         ("pendulum_chol", "pendulum", "UPPER_TRIANGULAR_CHOLESKY"))


def example_path(card, label, ex, codec):
    """One example at the bench shape in float32 (H=200, ten alphas,
    U0 = 0.1, B=1), as phase 5 runs the cartpole: the 50-iteration solve
    through the kernels with the launch counts from zero, K1 and K2 held
    against their plain versions at the local model of its result, their
    times alone, and one iteration through the kernels and through the
    plain versions in alternating turns, with its profile."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions, backward,
                                                 control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout, solve,
                                                 trajectory_cost)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_rollout as fr
    t0 = time.perf_counter()
    enc = StateEncoding[codec]
    ign = enc == StateEncoding.IGNORE_UNCERTAINTY
    dtype, H, A = torch.float32, 200, 10
    model, cost, x0 = example(ex, dtype)
    z0 = start_state(x0, enc)
    nu = model.action_size
    U0 = torch.full((H, nu), 0.1, dtype=dtype, device="cuda")
    alphas = default_fit_alphas(dtype, "cuda")
    Z0, AUX0 = rollout(model, z0, U0, enc)

    def line_search(kernels, Z, U, k, K):
        if kernels:
            out = fr.fused_control_law(model, Z, U, k, K, alphas, enc,
                                       cost=cost if ign else None)
        else:
            out = control_law(model, Z, U, k, K, alphas, enc,
                              cost=cost if ign else None, cost_in_scan=ign)
        if ign:
            return out
        return out + (trajectory_cost(cost, out[0], out[1], enc),)

    def iteration(kernels):
        derivs = local_model(Z0, U0, AUX0, model, cost, enc)
        if kernels:
            k, K, ok = bk.kernel_backward(*derivs, reg=0.0)
        else:
            k, K, ok = backward(*derivs, reg=0.0)
        Z_b, U_b, J_b = line_search(kernels, derivs[0], U0, k, K)
        amin = torch.argmin(torch.where(torch.isfinite(J_b), J_b,
                                        torch.inf)).reshape(1)
        return (Z_b.index_select(1, amin)[:, 0],
                U_b.index_select(1, amin)[:, 0], J_b[amin])

    def full_solve():
        opts = ILQROptions(n_iterations=50, riccati_mode="kernel",
                           fused_rollout=True)
        t1 = time.perf_counter()
        r = solve(model, cost, z0, U0, opts, encoding=enc)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t1), r

    # The path, once, with the launch counts from zero.
    bk.launches = 0
    reset_counts(fr.launches)
    ms_first, r_main = full_solve()
    counts = {"K1": bk.launches, **{"K2(" + k + ")": v
                                     for k, v in fr.launches.items()}}
    st = fr.stage(model, cost, enc)
    check(counts["K1"] == r_main.evals
          and counts["K2(" + st + ")"] == r_main.evals
          and sum(fr.launches.values()) == r_main.evals,
          "{}: launches {} differ from the solve's {} evaluations".format(
              label, counts, r_main.evals))
    check(bool(torch.isfinite(r_main.Z).all())
          and bool(torch.isfinite(r_main.U).all())
          and np.isfinite(r_main.J_opt), "{} solve output".format(label))

    # K1 and K2 against their plain versions at the local model of the
    # solve's result, the regularization doubled until the gains and the
    # plain line search's candidates are finite, as the solve's next
    # evaluations would escalate it (the double cartpole's f32 candidates
    # can diverge at the first reg that makes its gains finite).
    derivs = local_model(r_main.Z, r_main.U, (), model, cost, enc)
    Z_n, U_n = derivs[0], r_main.U
    reg = max(r_main.mu, 1e-6)
    for _ in range(64):
        (k_p, K_p, ok_p), k1_plain_ms = timed_call(
            lambda: backward(*derivs, reg=reg))
        if bool(ok_p):
            plain2, k2_plain_ms = timed_call(
                lambda: line_search(False, Z_n, U_n, k_p, K_p))
            if all(bool(torch.isfinite(x).all()) for x in plain2):
                break
        reg *= 2.0
    k_k, K_k, ok_k = bk.kernel_backward(*derivs, reg=reg)
    kern2 = line_search(True, Z_n, U_n, k_p, K_p)
    torch.cuda.synchronize()
    check(bool(ok_p) and bool(ok_k)
          and all(bool(torch.isfinite(x).all()) for x in plain2),
          "{}: non-finite values at the path's inputs (reg={}, plain ok "
          "{}, kernel ok {})".format(label, reg, bool(ok_p), bool(ok_k)))
    k1_abs = max(rel_err(k_k, k_p)[0], rel_err(K_k, K_p)[0])
    k1_rel = max(rel_err(k_k, k_p)[1], rel_err(K_k, K_p)[1])
    k2_abs = max(rel_err(a, b)[0] for a, b in zip(kern2[:2], plain2[:2]))
    k2_rel = max(rel_err(a, b)[1] for a, b in zip(kern2[:2], plain2[:2]))
    J_rel = float(((kern2[2] - plain2[2]).abs() / plain2[2].abs()).max())
    # K1 once more in float64 on the same local model: the float32 gains
    # of the double cartpole (chaotic, reg ~2e3) and of rendezvous (open
    # loop growing 1.099x a step, so V_zz reaches ~1e16 over 200 steps)
    # are ill-conditioned, and the kernel's and the plain version's
    # rounding part by up to a few percent there; in float64 they agree.
    d64 = [t.double() for t in derivs]
    k64_k, K64_k, _ = bk.kernel_backward(*d64, reg=reg)
    k64_p, K64_p, _ = backward(*d64, reg=reg)
    k1_rel64 = max(rel_err(k64_k, k64_p)[1], rel_err(K64_k, K64_p)[1])
    well_posed = ex == "pendulum"
    check(k1_rel64 <= 1e-8 and (k1_rel <= TOL[("K1", "float32")]
                                or not well_posed),
          "{}: K1 disagrees with plain at the path's inputs: f32 {} f64 "
          "{}".format(label, k1_rel, k1_rel64))
    # The double cartpole's closed loop is chaotic: over 200 steps in f32
    # the kernel's and the plain version's rounding part; its deviation
    # is recorded (phase 10 holds it at the golden horizon).
    check(ex == "double_cartpole" or (k2_rel <= 1e-4 and J_rel <= 1e-4),
          "{}: K2 disagrees with plain at the path's inputs: {} J {}"
          .format(label, k2_rel, J_rel))

    # The plain versions (0.1-3.3 s a call, host-bound): the one call of
    # each in the checks above, timed there (repeats cut for phase 19's
    # time).
    t = {"K1_ms": events_ms(raw_k1(derivs, reg), 200),
         "K1_plain_ms": k1_plain_ms,
         "K2_ms": events_ms(raw_k2(model, cost, Z_n, U_n, k_p, K_p, alphas,
                                   enc), 200),
         "K2_wrapper_ms": events_ms(lambda: line_search(
             True, Z_n, U_n, k_p, K_p), 50),
         "K2_plain_ms": k2_plain_ms}
    n, nz = model.state_size, Z_n.shape[-1]
    sweeps = k1_sweeps(derivs, reg)
    b1, f1 = k1_work(1, H, nz, nu, 4, sweeps=5 if sweeps is None else sweeps)
    b2, f2 = k2_work(1, H, A, 4, False, ex, int(enc))
    t["K1_bound_ms"], t["K1_bound_by"] = chain_bound_ms(
        b1, f1, "float32", k1_chain_cycles(nz, nu, "float32", sweeps),
        H)[:2]
    t["K2_bound_ms"], t["K2_bound_by"] = chain_bound_ms(
        b2, f2, "float32", k2_chain_cycles(ex, int(enc), nz, "float32"),
        H)[:2]

    turns = {"kernels": [], "plain": []}
    for kernels in TURNS:
        turns["kernels" if kernels else "plain"].append(events_ms(
            lambda: iteration(kernels), 10 if kernels else 1,
            warmup=2 if kernels else 0))
    # One timed run of the solve, the first (a second one, where the
    # state ignores uncertainty, cut for phase 19's time).
    solves = [ms_first]
    profile = device_profile(lambda: iteration(True))
    res = {"phase": 12, "path": label, "card": card, "dtype": "float32",
           "H": H, "A": A, "codec": codec, "nz": nz, "nu": nu,
           "K2_stage": st, "main_path_launches": counts,
           "main_path": {"state": r_main.state.name,
                         "iterations": r_main.iterations,
                         "evals": r_main.evals, "J": r_main.J_opt},
           "ddp_iteration_ms_{}_h200_kernels".format(label):
               min(turns["kernels"]),
           "ddp_iteration_ms_{}_h200_plain".format(label):
               min(turns["plain"]),
           "full_solve_ms_50iter_h200_{}".format(label): min(solves),
           "turns": turns, "full_solve_ms": solves,
           "max_abs_err": {"K1": k1_abs, "K2": k2_abs},
           "max_rel_err": {"K1": k1_rel, "K1_float64": k1_rel64,
                           "K2": k2_rel, "J": J_rel},
           "kernel_inputs_reg": reg,
           "idle_share": profile["idle_share"], "profile": profile,
           "seconds": time.perf_counter() - t0}
    res.update(t)
    emit(res)
    derivs0 = local_model(Z0, U0, AUX0, model, cost, enc)
    k0, K0, _ = bk.kernel_backward(*derivs0, reg=0.0)
    inputs = {"ex": ex, "model": model, "cost": cost, "enc": enc,
              "derivs": derivs, "reg": reg, "Z": Z_n, "U": U_n, "k": k_p,
              "K": K_p, "first": (derivs0[0], U0, k0, K0)}
    return res, inputs


def phase12_example_paths(card):
    t0 = time.perf_counter()
    out = {label: example_path(card, label, ex, codec)
           for label, ex, codec in PATHS}
    emit({"phase": 12, "seconds": time.perf_counter() - t0})
    return ({label: r for label, (r, _) in out.items()},
            {label: i for label, (_, i) in out.items()})


def _candidate_stats(model, Z_b):
    """The largest |angle| the candidates reach (finite values) and the
    share of non-finite state values."""
    import torch
    finite = torch.isfinite(Z_b)
    idx = list(getattr(model, "angular_indices", ()) or ())
    ang = Z_b[..., idx] if idx else Z_b[..., :0]
    ang = torch.where(torch.isfinite(ang), ang.abs(), torch.zeros_like(ang))
    return {"max_abs_angle": float(ang.max()) if ang.numel() else None,
            "nonfinite_share": float((~finite).to(torch.float64).mean())}


def phase13_kernel_times(card, path_inputs, bnn_k1):
    """K1 and K2 alone at every path's shape and inputs (phases 5, 8 and
    12; K2(d) at the BNN iteration's), for one solve and for 64 (the inputs
    repeated), by CUDA events
    after a warm-up, each beside its bound: the larger of its roofline and
    its chain floor (``chain_bound_ms``);
    and K2 at each path's first-iteration inputs (gains at reg=0 around
    U0 = 0.1) against its time at the solve's end, with the largest angle
    and the non-finite share its candidates reach at each."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    from pddp_tpu_torch.ops import fused_rollout as fr
    t0 = time.perf_counter()
    clock = max_sm_clock_mhz()
    alphas = default_fit_alphas(torch.float32, "cuda")
    A = alphas.shape[0]

    def rep(t, B):
        return t if B == 1 else t.expand((B,) + t.shape).contiguous()

    def k1_row(label, derivs, reg, B):
        N, nz, nu = derivs[2].shape
        d = [rep(t, B) for t in derivs]
        ms = events_ms(raw_k1(d, reg), 200 if B == 1 else 50)
        sweeps = k1_sweeps(derivs, reg)
        bound, by, roof, chain = chain_bound_ms(
            *k1_work(B, N, nz, nu, 4, sweeps=5 if sweeps is None else sweeps),
            "float32", k1_chain_cycles(nz, nu, "float32", sweeps), N)
        return {"kernel": "K1", "path": label, "B": B, "N": N, "nz": nz,
                "nu": nu, "ms": ms, "bound_ms": bound, "bound_by": by,
                "roofline_ms": roof, "chain_floor_ms": chain}

    rows = [k1_row("bnn", bnn_k1["derivs"], bnn_k1["reg"], B)
            for B in (1, 64)]
    # The plain backward at the BNN's shape: the scan the PDDP loop runs
    # on every evaluation (pddp_tpu's loop keeps K1 off).
    from pddp_tpu_torch.controllers.ilqr import backward
    rows[0]["plain_ms"] = events_ms(
        lambda: backward(*bnn_k1["derivs"], reg=bnn_k1["reg"]), 20)
    model = bnn_k1["model"]
    *ins, bnn_alphas = bnn_k1["rollout_args"]
    N, nz = ins[1].shape[1], ins[0].shape[-1]
    for B in (1, 64):
        args = [t if B == 1 else t[0].expand((B,) + t.shape[1:]).contiguous()
                for t in ins] + [bnn_alphas]
        ms = events_ms(raw_bnn(torch, "rollout", model, torch.float32, args),
                       200 if B == 1 else 20)
        bound, by, roof, chain = chain_bound_ms(
            *bnn_work(model, B, N, A, A, 4)["K2(d)"], "float32",
            k2d_chain_cycles(4, nz, [6, 200, 200, 8], model.n_particles,
                             "float32"), N)
        rows.append({"kernel": "K2(d)", "path": "bnn", "B": B, "N": N,
                     "nz": nz, "ms": ms, "bound_ms": bound, "bound_by": by,
                     "roofline_ms": roof, "chain_floor_ms": chain,
                     "plan": fb.launch_plan(
                         model, B * A, torch.float32,
                         StateEncoding.UPPER_TRIANGULAR_CHOLESKY)})
    for label, p in path_inputs.items():
        rows += [k1_row(label, p["derivs"], p["reg"], B) for B in (1, 64)]
        model, enc = p["model"], p["enc"]
        ign = enc == StateEncoding.IGNORE_UNCERTAINTY
        cost = p["cost"] if ign else None
        N, nz = p["U"].shape[0], p["Z"].shape[-1]
        cycles = k2_chain_cycles(p["ex"], int(enc), nz, "float32")
        st = fr.stage(model, cost, enc)
        for B in (1, 64):
            ins = [rep(t, B) for t in (p["Z"], p["U"], p["k"], p["K"])]
            ms = events_ms(raw_k2(model, cost, *ins, alphas, enc),
                           200 if B == 1 else 50)
            bound, by, roof, chain = chain_bound_ms(
                *k2_work(B, N, A, 4, False, p["ex"], int(enc)), "float32",
                cycles, N)
            rows.append({"kernel": "K2({})".format(st), "path": label,
                         "B": B, "N": N, "nz": nz, "ms": ms,
                         "bound_ms": bound, "bound_by": by,
                         "roofline_ms": roof, "chain_floor_ms": chain})
        # The first iteration's inputs against the solve's end.
        first = {"ms": events_ms(raw_k2(model, cost, *p["first"], alphas,
                                        enc), 200)}
        first.update(_candidate_stats(model, fr.fused_control_law(
            model, *p["first"], alphas, enc, cost=cost)[0]))
        end = _candidate_stats(model, fr.fused_control_law(
            model, p["Z"], p["U"], p["k"], p["K"], alphas, enc,
            cost=cost)[0])
        rows[-2].update({"first_iteration": first, "end": end})
        if cost is not None:   # the same candidates without the cost
            rows[-2]["ms_without_cost"] = events_ms(raw_k2(
                model, None, p["Z"], p["U"], p["k"], p["K"], alphas, enc),
                200)
        if label == "cartpole":  # 40 candidates: two warps a solve
            rows[-2]["ms_A40"] = events_ms(raw_k2(
                model, cost, p["Z"], p["U"], p["k"], p["K"], torch.logspace(
                    0.0, -3.0, 40, device="cuda"), enc), 200)
    rows += k1_block_times()
    emit({"phase": 13, "card": card, "dtype": "float32", "A": A,
          "sm_clock_max_mhz": clock, "rows": rows,
          "seconds": time.perf_counter() - t0})
    return rows


# The block kernel's timed shapes: (label, nz, nu), the belief codecs'
# widths of the bundled examples; and the warp kernel's nu = 4 instances,
# beside the bound of the block kernel's shorter clamp.
K1_BLOCK_TIMED = (("cartpole_full", 20, 1), ("double_cartpole_chol", 27, 1),
                  ("double_cartpole_full", 42, 1), ("rendezvous_chol", 44, 4),
                  ("rendezvous_full", 72, 4))
K1_WARP_NU4_TIMED = (("rendezvous", 8, 4), ("rendezvous_var", 16, 4))


def k1_block_times():
    """K1's block kernel alone at H=200 in float32, for 1 solve and 64, on
    phase 1's kind of inputs (reg=10, the clamp acting in the last steps),
    with its plan, beside its bound (the larger of the roofline and the
    chain floor, the same as the warp kernel's at that shape; the clamp's
    sweeps those its data needs, ``k1_sweeps``), the bound of the cyclic
    clamp (``k1_chain_cycles_cyclic``),
    the c-SM floor of its plan (not a bound: it says what holds the plan
    back), and the plain backward's time at B=1 (one call); then the warp
    kernel at K1_WARP_NU4_TIMED the same way."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import backward
    from pddp_tpu_torch.ops import backward_kernel as bk
    rows = []
    for label, nz, nu in K1_BLOCK_TIMED + K1_WARP_NU4_TIMED:
        ins = k1_inputs(np.random.default_rng(nz), 1, 200, nz, nu,
                        torch.float32, "cuda", True, shift=4.0)
        # One call, no warm-up (the plain backward ran in phase 1; a
        # warm-up call costs 6 s at nz = 44 and 72).
        plain_ms = events_ms(lambda: backward(*ins, reg=10.0), 1, warmup=0)
        sweeps = k1_sweeps(ins, 10.0)
        for B in (1, 64):
            d = [t if B == 1 else t.expand((B,) + t.shape[1:]).contiguous()
                 for t in ins]
            ms = events_ms(raw_k1(d, 10.0), 200 if B == 1 else 50)
            nbytes, flops = k1_work(B, 200, nz, nu, 4,
                                    sweeps=5 if sweeps is None else sweeps)
            bound, by, roof, chain = chain_bound_ms(
                nbytes, flops, "float32",
                k1_chain_cycles(nz, nu, "float32", sweeps), 200)
            plan = bk.launch_plan(nz, nu, torch.float32, B)
            row = {"kernel": "K1 " + plan["kernel"], "path": label, "B": B,
                   "N": 200, "nz": nz, "nu": nu, "ms": ms,
                   "bound_ms": bound, "bound_by": by, "roofline_ms": roof,
                   "chain_floor_ms": chain, "clamp_sweeps": sweeps,
                   "chain_floor_cyclic_clamp_ms": chain_ms(
                       k1_chain_cycles_cyclic(nz, nu, "float32"), 200,
                       max_sm_clock_mhz()),
                   "plan": plan}
            if plan["kernel"] == "block":
                row["c_sm_ms"] = c_sm_ms(flops, B, plan["cluster"],
                                         "float32")
            if B == 1:
                row["plain_ms"] = plain_ms
            rows.append(row)
    return rows


# Phase 14's configurations, (label, example, codec): the four examples
# under the default (Cholesky) codec, nz = 5, 14, 27, 44, and cartpole and
# rendezvous under the full covariance, nz = 20, 72, the widest shapes of
# the bundled examples; each at its golden case's horizon, start and U0.
ENTRY_CASES = (
    ("pendulum_chol", "pendulum", "UPPER_TRIANGULAR_CHOLESKY"),
    ("cartpole_chol", "cartpole", "UPPER_TRIANGULAR_CHOLESKY"),
    ("double_cartpole_chol", "double_cartpole", "UPPER_TRIANGULAR_CHOLESKY"),
    ("rendezvous_chol", "rendezvous", "UPPER_TRIANGULAR_CHOLESKY"),
    ("cartpole_full", "cartpole", "FULL_COVARIANCE_MATRIX"),
    ("rendezvous_full", "rendezvous", "FULL_COVARIANCE_MATRIX"))
ENTRY_ITERATIONS, ENTRY_TICKS = 4, 2
# The card's kernels against the CPU's plain versions, both float64: the
# golden tests' tolerances (J rtol 1e-6; Z, U and the ticks' controls
# rtol 1e-5, atol 1e-7).
ENTRY_TOL = {"J_rtol": 1e-6, "rtol": 1e-5, "atol": 1e-7}
# The float32 fits' J through the kernels against the plain backward's:
# phase 4's float32 J tolerance.
ENTRY_F32_J_RTOL = 1e-5
# The shapes timed through the kernels and through the plain backward.
ENTRY_TIMED = ("rendezvous_chol", "rendezvous_full")


def entry_point(ex, codec, device, dtype, riccati_mode, fused_rollout):
    """The README's Quick start through the port: the example's env at its
    golden start, ``iLQRController(env, model, cost, riccati_mode,
    fused_rollout).fit(U0)`` for ENTRY_ITERATIONS iterations, then
    ENTRY_TICKS ticks of ``forward(z, t, mpc=True)`` on the env's encoded
    state, each control applied to the env. Returns the fit's Z, U, J and
    end state, the controls, the env's end state, the evaluations of
    every solve, the fit's wall and each tick's (host clock to
    ``synchronize``), and the controller."""
    import importlib

    import torch
    from pddp_tpu_torch.controllers import iLQRController
    from pddp_tpu_torch.convert import golden_U0
    from pddp_tpu_torch.encoding import StateEncoding
    mod, _, cost_cls, x0, dt, _ = EXAMPLES[ex]
    m = importlib.import_module("pddp_tpu_torch.examples." + mod)
    env = getattr(m, cost_cls.replace("Cost", "Env"))(dt=dt, device=device,
                                                      dtype=dtype)
    env.set_state(x0)
    cost = getattr(m, cost_cls)(device=device, dtype=dtype)
    ctrl = iLQRController(env, env.model, cost, riccati_mode=riccati_mode,
                          fused_rollout=fused_rollout)
    enc = StateEncoding[codec]
    U0 = torch.as_tensor(golden_U0(ex), dtype=dtype, device=device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    Z, U, state = ctrl.fit(U0, encoding=enc, n_iterations=ENTRY_ITERATIONS)
    sync()
    out = {"fit_ms": 1e3 * (time.perf_counter() - t0),
           "Z": Z.cpu(), "U": U.cpu(), "J": ctrl.last_result.J_opt,
           "state": state.name, "evals": [ctrl.last_result.evals],
           "u": [], "tick_ms": [], "tick_states": []}
    for t in range(ENTRY_TICKS):
        z = env.get_state().encode(enc)
        t1 = time.perf_counter()
        u = ctrl.forward(z, t, enc, mpc=True)
        sync()
        out["tick_ms"].append(1e3 * (time.perf_counter() - t1))
        out["evals"].append(ctrl.last_result.evals)
        out["tick_states"].append(ctrl.last_result.state.name)
        out["u"].append(u.cpu())
        env.apply(u)
    out["u"] = torch.stack(out["u"])
    out["x_end"] = env.get_state().mean().cpu()
    out["ctrl"] = ctrl
    return out


def phase14_entry_point(card, cpu_runs):
    """The slice's path: ``entry_point`` on the card in float64 through K1
    (``riccati_mode="kernel"``) and K2 (``fused_rollout=True``) at every
    configuration of ENTRY_CASES, with the launch counts from zero, held
    against the same calls through the plain versions on the CPU in
    float64 (``cpu_runs``, made by ``cpu_references`` beside the build);
    K1 against its plain version at the fitted local model; then
    in float32 the fit's and a tick's wall at ENTRY_TIMED, through the
    kernels and through the plain backward (K2 kept), in alternating
    turns, each fit's J held against the plain backward's."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import backward, local_model
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_rollout as fr
    t0 = time.perf_counter()
    rows, counts_total = [], {"K1_warp": 0, "K1_block": 0, "K2": 0}
    block_abs = 0.0
    for label, ex, codec in ENTRY_CASES:
        bk.launches = 0
        bk.block_launches = 0
        reset_counts(fr.launches)
        card_run = entry_point(ex, codec, "cuda", torch.float64, "kernel",
                               True)
        counts = {"K1_warp": bk.launches, "K1_block": bk.block_launches,
                  "K2": sum(fr.launches.values())}
        cpu = cpu_runs[label]
        evals = sum(card_run["evals"])
        nz = card_run["Z"].shape[-1]
        nu = card_run["U"].shape[-1]
        block = (nz, nu) not in bk.INSTANCES
        # K1 at the fit's local model, against its plain version.
        ctrl = card_run["ctrl"]
        derivs = local_model(card_run["Z"].cuda(), card_run["U"].cuda(), (),
                             ctrl.model, ctrl.cost, StateEncoding[codec])
        reg = max(ctrl.last_result.mu, 1e-6)
        n_b = (bk.launches, bk.block_launches)
        k_k, K_k, _ = bk.kernel_backward(*derivs, reg=reg)
        bk.launches, bk.block_launches = n_b
        k_p, K_p, _ = backward(*derivs, reg=reg)
        # Relative to the largest gain of k and K together: at a converged
        # fit k is near zero and its own scale says nothing.
        k1_abs = max(rel_err(k_k, k_p)[0], rel_err(K_k, K_p)[0])
        k1_rel = k1_abs / max(float(k_p.abs().max()),
                              float(K_p.abs().max()), 1e-300)
        if block:
            block_abs = max(block_abs, k1_abs)
        row = {"path": label, "nz": nz, "nu": nu, "dtype": "float64",
               "N": card_run["U"].shape[0], "K1": "block" if block
               else "warp", "launches": counts, "evals": card_run["evals"],
               "cpu_evals": cpu["evals"], "state": card_run["state"],
               "cpu_state": cpu["state"],
               "tick_states": card_run["tick_states"],
               "cpu_tick_states": cpu["tick_states"],
               "J": card_run["J"], "J_rel": abs(card_run["J"] - cpu["J"])
               / abs(cpu["J"]),
               "Z_abs": rel_err(card_run["Z"], cpu["Z"])[0],
               "U_abs": rel_err(card_run["U"], cpu["U"])[0],
               "u_abs": rel_err(card_run["u"], cpu["u"])[0],
               "x_end_abs": rel_err(card_run["x_end"], cpu["x_end"])[0],
               "K1_abs": k1_abs, "K1_rel": k1_rel, "K1_reg": reg,
               "fit_ms": card_run["fit_ms"], "tick_ms": card_run["tick_ms"],
               "cpu_fit_ms": cpu["fit_ms"]}
        rows.append(row)
        for key in counts_total:
            counts_total[key] += counts[key]
        check(counts["K1_warp"] + counts["K1_block"] == evals
              and counts["K1_block" if block else "K1_warp"] == evals
              and counts["K2"] == evals,
              "{}: K1/K2 launches {} differ from the {} evaluations".format(
                  label, counts, evals))
        for key, a, b in (("Z", card_run["Z"], cpu["Z"]),
                          ("U", card_run["U"], cpu["U"]),
                          ("u", card_run["u"], cpu["u"]),
                          ("x_end", card_run["x_end"], cpu["x_end"])):
            check(bool(torch.isfinite(a).all()) and torch.allclose(
                a, b, rtol=ENTRY_TOL["rtol"], atol=ENTRY_TOL["atol"]),
                "{}: {} differs from the CPU's plain run: {}".format(
                    label, key, row))
        check(row["J_rel"] <= ENTRY_TOL["J_rtol"],
              "{}: J differs from the CPU's: {}".format(label, row))
        # Rendezvous is linear-quadratic: after its first step candidates
        # tie within an ulp and the order of sums decides between
        # CONVERGED and MAX_REG (ROADMAP C); elsewhere the ends agree.
        check(ex == "rendezvous" or (
            row["state"] == row["cpu_state"]
            and row["tick_states"] == row["cpu_tick_states"]
            and row["evals"] == row["cpu_evals"]),
            "{}: end states differ from the CPU's: {}".format(label, row))
        check(k1_rel <= 1e-8, "{}: K1 against plain at the fitted model: "
              "{}".format(label, row))
    timed = {}
    for label, ex, codec in ENTRY_CASES:
        if label not in ENTRY_TIMED:
            continue
        turns = {"kernels": [], "plain_backward": []}
        for kernels in TURNS:
            r = entry_point(ex, codec, "cuda", torch.float32,
                            "kernel" if kernels else "scan", True)
            turns["kernels" if kernels else "plain_backward"].append(
                {"fit_ms": r["fit_ms"], "tick_ms": r["tick_ms"],
                 "evals": r["evals"], "state": r["state"],
                 "J": float(r["J"])})
        timed[label] = turns
        # Where the rendezvous tie ends the solve (MAX_REG or CONVERGED)
        # may differ; the cost it ends at may not.
        ref = turns["plain_backward"][0]["J"]
        for r in turns["kernels"] + turns["plain_backward"]:
            check(np.isfinite(r["J"]) and abs(r["J"] - ref)
                  <= ENTRY_F32_J_RTOL * abs(ref),
                  "{}: the float32 fit's J {} differs from the plain "
                  "backward's {}".format(label, r, ref))
    res = {"phase": 14, "card": card, "cases": rows,
           "launches": counts_total, "K1_block_max_abs_err": block_abs,
           "timed_float32": timed, "seconds": time.perf_counter() - t0}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# Phase 15: the PDDP episodic loop (PDDPController, BNN training)
# ---------------------------------------------------------------------------

# examples/experiment.py's configuration: dt, hidden widths, particles,
# action bound of the cartpole, training recipe.
PDDP_DT, PDDP_HIDDEN, PDDP_P, PDDP_UMAX = 0.1, [200, 200], 100, 10.0
PDDP_TRAINING = {"n_iter": 500, "learning_rate": 1e-3}
# 15a and 15b run the MPC trial's first 4 ticks of 2N (a tick takes
# ~0.7 s in 15a's float64 and ~1.2 s in 15b's float32, host-bound; 15a's
# seventh took 10 evaluations when they ran 7, cut for phase 19's time).
PDDP_MPC_TICKS = 4
# 15a: one trial on the card and on the CPU, float64, the same numpy-made
# draws; held within 1e-8 (max |card - CPU| / max |CPU| of each array):
# both do the same arithmetic in another order of sums, through 20
# optimizer steps, 3 iterations and 7 MPC ticks (the seventh takes 10
# evaluations).
PDDP_15A = {"N": 10, "n_iter": 20, "n_iterations": 3}
PDDP_15A_TOL = 1e-8
# 15b: the experiment at N=25, cut to one trial and 10 iterations a fit.
PDDP_15B = {"N": 25, "n_iterations": 10}
PDDP_15B_J_RTOL = 1e-5   # the kernel fit's J against the scan fit's
# 15c: scripts/make_trained_bnn.py's recipe, and twice the held-out error
# that pddp_tpu's run recorded in tests/golden/trained_bnn_cartpole.npz.
PDDP_15C = {"n_data": 4096, "n_iter": 4000, "batch_size": 128,
            "learning_rate": 1e-3, "n_val": 512, "seed": 42}
PDDP_15C_MAE_CAP = 2 * 0.04357742890715599
# 15d: tests/controllers/test_pddp_learning.py's configuration, cut to
# one MPC trial (max_trials 3 of 4: two exploration trials, then MPC).
PDDP_15D = {"N": 15, "P": 30, "hidden": [64, 64], "n_iter": 400,
            "max_trials": 3, "n_iterations": 15, "umax": 2.5}


def pddp_problem(problem, device, dtype, N, hidden, P, seed=0):
    """(env, cost, BNN model) of a SampleProblems name: the registry's
    env and cost, and an untrained BNN of the problem's sizes and angles
    (numpy seed ``seed``) with a noise table of 2N + 1 steps."""
    from pddp_tpu_torch.examples.problems import SampleProblems
    from pddp_tpu_torch.models.bnn import bnn_dynamics_model_factory
    sp = SampleProblems[problem]
    env, cost, _ = sp.setup(PDDP_DT, seed=seed, device=device, dtype=dtype)
    mc = sp.get_model_class()
    cls = bnn_dynamics_model_factory(env.state_size, env.action_size,
                                     hidden, mc.angular_indices,
                                     mc.non_angular_indices)
    model = cls.init(seed=seed, n_particles=P, horizon=2 * N + 1,
                     dtype=dtype, device=device)
    return env, cost, model


def numpy_draws(rng, model, N, n_init, n_mpc_trials, training,
                max_dataset_size=1000):
    """Every draw of a PDDPController.fit, made by numpy, in the loop's
    order (see controllers/pddp.py): the exploration actions, the first
    fit's batches and noise, then each MPC trial's resample and fit."""
    nu = model.action_size
    widths = [layer.W.shape[1] for layer in model.net.layers[:-1]]
    n_iter, batch = training["n_iter"], training.get("batch_size", 128)

    def fit(n_valid):
        return ("fit", {
            "batch_idx": rng.integers(0, n_valid, (n_iter, batch)),
            "noise": [rng.uniform(1e-5, 1.0 - 1e-5, (n_iter, batch, w))
                      for w in widths]})

    shape = tuple(model.eps_in.shape)
    draws = [("explore", rng.random((N, nu))) for _ in range(n_init - 1)]
    rows = n_init * N
    draws.append(fit(min(rows, max_dataset_size)))
    for _ in range(n_mpc_trials):
        draws.append(("resample", {
            "eps_out": rng.standard_normal(shape),
            "eps_in": rng.standard_normal(shape),
            "net": [rng.uniform(1e-5, 1.0 - 1e-5, (model.n_particles, w))
                    for w in widths]}))
        rows += 2 * N
        draws.append(fit(min(rows, max_dataset_size)))
    return draws


def recorded_pddp_fit(ctrl, U0, enc, umax, sync, **fit_kwargs):
    """``ctrl.fit`` with its parts recorded and timed (host clock to
    ``sync``): each collected trial's data, cost and wall; each model
    fit and its wall; each iLQR fit's result and wall; each MPC tick's
    wall and evaluations. Each MPC trial is cut to its first
    ``PDDP_MPC_TICKS`` ticks (a shorter trial, not a sample of a longer
    one)."""
    rec = {"trials": [], "fits": [], "solves": [], "ticks": []}
    apply_controller, fit_model = ctrl._apply_controller, ctrl._fit_model
    solve, forward = ctrl._solve, ctrl.forward
    in_mpc = [False]

    def timed(fn, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    def rec_apply(controller, H, *args, **kwargs):
        in_mpc[0] = bool(kwargs.get("mpc"))
        if in_mpc[0]:
            H = min(H, PDDP_MPC_TICKS)
        (data, J), ms = timed(apply_controller, controller, H, *args,
                              **kwargs)
        in_mpc[0] = False
        rec["trials"].append({"data": data, "J": float(J), "ms": ms,
                              "mpc": bool(kwargs.get("mpc"))})
        return data, J

    def rec_fit_model(*args, **kwargs):
        model, ms = timed(fit_model, *args, **kwargs)
        rec["fits"].append({"model": model, "ms": ms})
        return model

    def rec_solve(*args, **kwargs):
        if in_mpc[0]:
            return solve(*args, **kwargs)
        result, ms = timed(solve, *args, **kwargs)
        rec["solves"].append({"result": result, "ms": ms})
        return result

    def rec_forward(*args, **kwargs):
        u, ms = timed(forward, *args, **kwargs)
        rec["ticks"].append({"ms": ms, "evals": ctrl.last_result.evals})
        return u

    ctrl._apply_controller, ctrl._fit_model = rec_apply, rec_fit_model
    ctrl._solve, ctrl.forward = rec_solve, rec_forward
    (Z, U, state), rec["ms"] = timed(
        ctrl.fit, U0, encoding=enc, quiet=True, u_min=-umax, u_max=umax,
        **fit_kwargs)
    ctrl._apply_controller, ctrl._fit_model = apply_controller, fit_model
    ctrl._solve, ctrl.forward = solve, forward
    rec.update(Z=Z, U=U, state=state)
    return rec


def _model_arrays(model):
    return model.net.leaves() + [getattr(model, k) for k in
                                 ("X_mean", "X_std", "dX_mean", "dX_std")]


def pddp_walls(rec, training):
    """The trial's wall split: collection, training (ms per optimizer
    step), the iLQR fit (ms per iteration) and MPC collection (ms per
    tick), from ``recorded_pddp_fit``."""
    init = [t["ms"] for t in rec["trials"] if not t["mpc"]]
    mpc = [t["ms"] for t in rec["trials"] if t["mpc"]]
    fit_ms = sum(s["ms"] for s in rec["solves"])
    iters = sum(s["result"].iterations for s in rec["solves"])
    train_ms = sum(f["ms"] for f in rec["fits"])
    steps = training["n_iter"] * len(rec["fits"])
    ticks = [t["ms"] for t in rec["ticks"]]
    return {"total_ms": rec["ms"], "collection_ms": sum(init),
            "training_ms": train_ms, "training_ms_per_step": train_ms / steps,
            "fit_ms": fit_ms, "fit_iterations": iters,
            "fit_ms_per_iteration": fit_ms / max(iters, 1),
            "mpc_collection_ms": sum(mpc), "mpc_ticks": len(ticks),
            "mpc_ms_per_tick": sum(ticks) / max(len(ticks), 1),
            "tick_ms_min_max": [min(ticks), max(ticks)] if ticks else None,
            "tick_evals": [t["evals"] for t in rec["ticks"]]}


def phase15a_card_vs_cpu(card):
    """One PDDP trial at full width (the cartpole BNN 6-200-200-8, P=100,
    Cholesky codec, N=10, the MPC trial cut to its first PDDP_MPC_TICKS
    ticks) on the card and on the CPU in float64 with the same numpy-made
    draws: every dataset, trained model, iLQR fit and the MPC trial's cost
    alike."""
    import torch
    from pddp_tpu_torch.controllers import PDDPController
    from pddp_tpu_torch.encoding import StateEncoding
    t_start = time.perf_counter()
    enc = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    N, dtype = PDDP_15A["N"], torch.float64
    training = {**PDDP_TRAINING, "n_iter": PDDP_15A["n_iter"]}
    rng = np.random.default_rng(15)
    U0 = rng.uniform(-PDDP_UMAX, PDDP_UMAX, (N, 1))
    runs = {}
    for device in ("cuda", "cpu"):
        env, cost, model = pddp_problem("CARTPOLE", device, dtype, N,
                                        PDDP_HIDDEN, PDDP_P)
        draws = numpy_draws(np.random.default_rng(16), model, N, 2, 1,
                            training)
        ctrl = PDDPController(env, model, cost, training_opts=training,
                              draws=draws)
        umax = torch.full((1,), PDDP_UMAX, dtype=dtype, device=device)

        def sync(device=device):
            if device == "cuda":
                torch.cuda.synchronize()
        runs[device] = recorded_pddp_fit(
            ctrl, torch.as_tensor(U0, dtype=dtype, device=device), enc,
            umax, sync, max_trials=1, n_initial_sample_trajectories=2,
            n_iterations=PDDP_15A["n_iterations"])
        runs[device]["ctrl"] = ctrl
    card_run, cpu = runs["cuda"], runs["cpu"]
    errs = {}

    def hold(name, a, b):
        e = rel_err(a.detach().cpu(), b.detach())[1]
        errs[name] = max(errs.get(name, 0.0), e)

    check(len(card_run["trials"]) == len(cpu["trials"]) == 3
          and len(card_run["fits"]) == len(cpu["fits"]) == 2
          and len(card_run["solves"]) == len(cpu["solves"]) == 1,
          "15a: the loops differ in shape")
    for a, b in zip(card_run["trials"], cpu["trials"]):
        for name, x, y in zip(("X", "U", "dX"), a["data"], b["data"]):
            hold("trial_" + name, x, y)
        key = "mpc_J" if a["mpc"] else "trial_J"
        errs[key] = max(errs.get(key, 0.0),
                        abs(a["J"] - b["J"]) / abs(b["J"]))
    for a, b in zip(card_run["fits"], cpu["fits"]):
        for x, y in zip(_model_arrays(a["model"]), _model_arrays(b["model"])):
            hold("model", x, y)
    for a, b in zip(card_run["solves"], cpu["solves"]):
        hold("fit_Z", a["result"].Z, b["result"].Z)
        hold("fit_U", a["result"].U, b["result"].U)
        errs["fit_J"] = abs(a["result"].J_opt - b["result"].J_opt) / abs(
            b["result"].J_opt)
    res = {"phase": "15a", "card": card, "dtype": "float64", "N": N,
           "P": PDDP_P, "hidden": PDDP_HIDDEN, "training": training,
           "cut": {"mpc_ticks": [PDDP_MPC_TICKS, 2 * N]},
           "tol": PDDP_15A_TOL, "rel_err": errs,
           "fit_state": [card_run["state"].name, cpu["state"].name],
           "tick_evals": [[t["evals"] for t in r["ticks"]]
                          for r in (card_run, cpu)],
           "mpc_J": [card_run["trials"][-1]["J"], cpu["trials"][-1]["J"]],
           "walls_card": pddp_walls(card_run, training),
           "walls_cpu": pddp_walls(cpu, training),
           "seconds": time.perf_counter() - t_start}
    emit(res)
    for name, e in errs.items():
        check(np.isfinite(e) and e <= PDDP_15A_TOL,
              "15a: {} differs between the card and the CPU: {}".format(
                  name, errs))
    return res


def bnn_kernel_checks(model, cost, env, U, enc, dtype):
    """On a trained BNN, float32: one iteration's backward through K1
    against the plain backward and its line search through K2(d) against
    the plain line search (phase 8's tolerances), and
    ``iLQRController(riccati_mode="kernel").fit`` against the scan fit
    from the env's state. Returns the errors, walls and launch counts
    (the counts from zero)."""
    import torch
    from pddp_tpu_torch.controllers import iLQRController
    from pddp_tpu_torch.controllers.ilqr import (backward, control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout)
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    from pddp_tpu_torch.ops import fused_rollout as fr
    x0 = env.get_state().mean().clone()
    z0 = env.get_state().encode(enc)
    bk.launches = 0
    reset_counts(fb.launches)
    Z, AUX = rollout(model, z0, U, enc)
    derivs = local_model(Z, U, AUX, model, cost, enc)
    k_k, K_k, ok_k = bk.kernel_backward(*derivs, reg=1.0)
    k_p, K_p, ok_p = backward(*derivs, reg=1.0)
    check(bool(ok_p) and bool(ok_k), "non-finite gains at the trained BNN")
    alphas = default_fit_alphas(dtype, "cuda")
    out_k = fr.fused_control_law(model, derivs[0], U, k_p, K_p, alphas, enc,
                                 with_aux=True)
    out_p = control_law(model, derivs[0], U, k_p, K_p, alphas, enc,
                        with_aux=True)
    from pddp_tpu_torch.controllers.ilqr import trajectory_cost
    J_k = trajectory_cost(cost, out_k[0], out_k[1], enc)
    J_p = trajectory_cost(cost, out_p[0], out_p[1], enc)
    fits = {}
    for mode in ("kernel", "scan"):
        env.set_state(x0)
        ctrl = iLQRController(env, model, cost, riccati_mode=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl.fit(U, encoding=enc, n_iterations=PDDP_15B["n_iterations"])
        torch.cuda.synchronize()
        fits[mode] = {"ms": 1e3 * (time.perf_counter() - t0),
                      "J": ctrl.last_result.J_opt,
                      "state": ctrl.last_result.state.name,
                      "evals": ctrl.last_result.evals}
        if mode == "kernel":
            counts = {"K1": bk.launches, "K2(d)": fb.launches["rollout"]}
    env.set_state(x0)
    K1_rel = max(rel_err(k_k, k_p)[0], rel_err(K_k, K_p)[0]) / max(
        float(k_p.abs().max()), float(K_p.abs().max()))
    J_rel = ((J_k - J_p).abs() / J_p.abs())
    res = {"launches": counts, "K1_rel": K1_rel,
           "K2(d)_J_rel_max": float(J_rel.max()),
           "K2(d)_Z_abs": rel_err(out_k[0], out_p[0])[0],
           "fits": fits,
           "fit_J_rel": abs(fits["kernel"]["J"] - fits["scan"]["J"])
           / abs(fits["scan"]["J"])}
    check(counts["K1"] == 1 + fits["kernel"]["evals"]
          and counts["K2(d)"] == 1,
          "15b: the trained model's checks did not launch K1 and K2(d): "
          "{}".format(counts))
    check(K1_rel <= TOL[("K1", "float32")],
          "15b: K1 off the plain backward on the trained BNN: {}".format(res))
    check(float(J_rel.max()) <= BNN_TOL["float32_J_N25"],
          "15b: K2(d) off the plain line search on the trained BNN: "
          "{}".format(res))
    check(np.isfinite(res["fit_J_rel"])
          and res["fit_J_rel"] <= PDDP_15B_J_RTOL,
          "15b: the kernel fit's J off the scan fit's: {}".format(res))
    return res


def phase15b_experiment(card):
    """examples/experiment.py's cartpole trial in float32 on the card
    (N=25, dt=0.1, 6-200-200-8, P=100, 500 AMSGrad steps at lr 1e-3,
    actions in +-10, U0 uniform in the bounds; cut to one trial and 10
    iterations a fit, and the MPC trial to its first PDDP_MPC_TICKS
    ticks), timed part by part, a profile of one MPC tick and one training
    step, then K1 and K2(d) on the model it trained."""
    import torch
    from pddp_tpu_torch.controllers import PDDPController
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.models.bnn import fit_bnn
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    t_start = time.perf_counter()
    enc = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    N, dtype = PDDP_15B["N"], torch.float32
    env, cost, model = pddp_problem("CARTPOLE", "cuda", dtype, N,
                                    PDDP_HIDDEN, PDDP_P)
    umax = torch.full((1,), PDDP_UMAX, dtype=dtype, device="cuda")
    U0 = torch.as_tensor(np.random.default_rng(1).uniform(
        -PDDP_UMAX, PDDP_UMAX, (N, 1)), dtype=dtype, device="cuda")
    ctrl = PDDPController(env, model, cost, training_opts=PDDP_TRAINING,
                          seed=0)
    bk.launches = 0
    reset_counts(fb.launches)
    rec = recorded_pddp_fit(ctrl, U0, enc, umax, torch.cuda.synchronize,
                            max_trials=1, n_initial_sample_trajectories=2,
                            n_iterations=PDDP_15B["n_iterations"])
    loop_s = time.perf_counter() - t_start
    loop_launches = {"K1": bk.launches, "K2(d)": fb.launches["rollout"]}
    walls = pddp_walls(rec, PDDP_TRAINING)
    check(bool(torch.isfinite(rec["Z"]).all())
          and tuple(rec["Z"].shape) == (N + 1, 14)
          and all(np.isfinite(t["J"]) for t in rec["trials"]),
          "15b: the trial's output is not finite")
    # Profiles: one MPC tick from the env's state, one optimizer step.
    z = env.get_state().encode(enc)
    tick = device_profile(lambda: ctrl.forward(z, 0, enc, mpc=True,
                                               u_min=-umax, u_max=umax))
    X, U_, dX = (torch.cat([t["data"][k] for t in rec["trials"]])
                 for k in range(3))
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = device_profile(lambda: fit_bnn(
        ctrl.model, X, U_, dX, generator=gen, n_iter=1,
        learning_rate=1e-3))
    check(tick["kernel_launches"] > 0 and step["kernel_launches"] > 0,
          "15b: the profiles saw no kernel: {} {}".format(tick, step))
    profiles_s = time.perf_counter() - t_start - loop_s
    env.reset()
    checks = bnn_kernel_checks(ctrl.model, cost, env, rec["U"], enc, dtype)
    res = {"phase": "15b", "card": card, "dtype": "float32", "N": N,
           "P": PDDP_P, "hidden": PDDP_HIDDEN, "training": PDDP_TRAINING,
           "cut": {"max_trials": [1, 5], "n_iterations": [10, 50],
                   "mpc_ticks": [PDDP_MPC_TICKS, 2 * N]},
           "walls": walls, "fit_state": rec["state"].name,
           "trial_J": [t["J"] for t in rec["trials"]],
           "loop_launches": loop_launches, "tick_profile": tick,
           "train_step_profile": step, "trained_model": checks,
           "seconds": time.perf_counter() - t_start,
           "seconds_loop_profiles": [loop_s, profiles_s]}
    emit(res)
    return res


def cartpole_transitions(rng, n, device, dtype):
    """scripts/make_trained_bnn.py's data, drawn by numpy through the
    port's analytic cartpole (dt=0.1): 3/4 uniform over the swing-up box,
    1/4 from 8-step rollouts of 128 episodes from the start region."""
    import torch
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleDynamicsModel
    model = CartpoleDynamicsModel(dt=PDDP_DT, device=device, dtype=dtype)

    def f(x, u):
        return model.apply(x, u, 0, (), StateEncoding.IGNORE_UNCERTAINTY)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    n_box = 3 * n // 4
    X_box = t(rng.uniform([-2.0, -6.0, -np.pi, -8.0],
                          [2.0, 6.0, np.pi, 8.0], (n_box, 4)))
    U_box = t(rng.uniform(-20.0, 20.0, (n_box, 1)))
    x = t(0.1 * rng.standard_normal((128, 4)))
    U_roll = t(rng.uniform(-10.0, 10.0, (8, 128, 1)))
    Xs = []
    for i in range(8):
        Xs.append(x)
        x = f(x, U_roll[i])
    X = torch.cat([X_box, torch.cat(Xs)[:n - n_box]])
    U = torch.cat([U_box, U_roll.reshape(-1, 1)[:n - n_box]])
    return X, U, f(X, U) - X


def phase15c_training(card):
    """scripts/make_trained_bnn.py's recipe through the port on the card,
    float32: 4096 transitions, 4000 AMSGrad steps of batch 128 at lr 1e-3
    on the bench's net (6-200-200-8, P=100), then the mean prediction's
    error on 512 fresh transitions."""
    import torch
    from pddp_tpu_torch.models.bnn import fit_bnn
    c = PDDP_15C
    t_start = time.perf_counter()
    rng = np.random.default_rng(c["seed"])
    X, U, dX = cartpole_transitions(rng, c["n_data"], "cuda", torch.float32)
    model = bnn_model(torch, torch.float32, 25, False)
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses = fit_bnn(model, X, U, dX, generator=gen,
                            n_iter=c["n_iter"], batch_size=c["batch_size"],
                            learning_rate=c["learning_rate"],
                            return_losses=True)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    Xv, Uv, dXv = (a[:c["n_val"]] for a in cartpole_transitions(
        rng, c["n_data"], "cuda", torch.float32))
    Xp = Xv[:, None, :].expand(-1, model.n_particles, -1)
    pred = model.forward_particles(Xp, Uv, 0).mean(dim=-2) - Xv
    mae = float((pred - dXv).abs().mean())
    res = {"phase": "15c", "card": card, "dtype": "float32", **c,
           "ms": ms, "ms_per_step": ms / c["n_iter"],
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "val_mean_abs_err": mae,
           "val_mean_abs_dx": float(dXv.abs().mean()),
           "mae_cap": PDDP_15C_MAE_CAP,
           "seconds": time.perf_counter() - t_start}
    emit(res)
    check(bool(torch.isfinite(losses).all()) and mae <= PDDP_15C_MAE_CAP,
          "15c: held-out error {} past {}".format(mae, PDDP_15C_MAE_CAP))
    return res


def phase15d_learning(card):
    """tests/controllers/test_pddp_learning.py's run on the card, float64:
    the pendulum, BNN [64, 64], P=30, N=15, 400 steps a fit at lr 1e-3,
    15 iterations, actions in +-2.5, Cholesky codec, cut to 3 trials (of
    4); the best MPC trial's env cost per step must beat the random
    trial's."""
    import torch
    from pddp_tpu_torch.controllers import PDDPController
    from pddp_tpu_torch.encoding import StateEncoding
    c = PDDP_15D
    t0 = time.perf_counter()
    dtype = torch.float64
    env, cost, model = pddp_problem("PENDULUM", "cuda", dtype, c["N"],
                                    c["hidden"], c["P"])
    ctrl = PDDPController(env, model, cost, training_opts={
        "n_iter": c["n_iter"], "learning_rate": 1e-3})
    ign = StateEncoding.IGNORE_UNCERTAINTY
    per_step = []

    def on_trial(trial, X, U):
        J = float(cost(X, U, torch.arange(U.shape[0], device="cuda"),
                       terminal=False, encoding=ign).sum())
        per_step.append(J / U.shape[0])

    umax = torch.full((1,), c["umax"], dtype=dtype, device="cuda")
    ctrl.fit(0.1 * torch.ones((c["N"], 1), dtype=dtype, device="cuda"),
             encoding=StateEncoding.UPPER_TRIANGULAR_CHOLESKY,
             max_trials=c["max_trials"], n_initial_sample_trajectories=2,
             n_iterations=c["n_iterations"], on_trial=on_trial,
             u_min=-umax, u_max=umax)
    random_cost, best = per_step[1], min(per_step[2:])
    res = {"phase": "15d", "card": card, "dtype": "float64", **c,
           "cut": {"max_trials": [c["max_trials"], 4]},
           "per_step_cost": per_step, "random_over_best_mpc":
           random_cost / best, "seconds": time.perf_counter() - t0}
    emit(res)
    check(len(per_step) == c["max_trials"] and best < random_cost,
          "15d: trained MPC does not beat random exploration: {}".format(
              per_step))
    return res


def phase15_pddp(card):
    """Phase 15, the PDDP loop: 15a, 15b, 15c, 15d."""
    t0 = time.perf_counter()
    out = {"a": phase15a_card_vs_cpu(card), "b": phase15b_experiment(card),
           "c": phase15c_training(card), "d": phase15d_learning(card)}
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": 15, "seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# Phase 16: batched solves at bench.py's width
# ---------------------------------------------------------------------------

# bench.py:187-208: B cartpole solves of horizon H, 5 iterations, 15
# evaluations at most, the cost summed inside the line search's loop.
BATCHED_B, BATCHED_H = 1024, 200
BATCHED_OPTS = {"n_iterations": 5, "max_evals": 15}
# Lanes of 16a held against the CPU's unbatched solve, spread over B.
BATCHED_CPU_LANES = 8
# bench.py:375-430: the BNN of phase 8 at B=1024 in chunks of 256, N=25.
BNN_BATCH = {"B": 1024, "chunk": 256, "N": 25}
# bench.py's BNN rows: (name, trained weights, the net's precision option,
# solves). The trained row runs the batch's first 256 lanes as one chunk
# (1024 in 4 chunks until phase 21 needed the time; the chunks are solved
# one after another, so its lanes end as they did), the untrained and
# bf16 rows its first 128 (256 until phase 19 needed the time), each
# with that batch in its name, so that the run fits its time; bench.py
# runs them at B=1024.
BNN_BATCH_ROWS = (
    ("pddp_bnn_solves_per_sec_b256_trained", True, None, 256),
    ("pddp_bnn_solves_per_sec_b128_h25_p100_5iter", False, None, 128),
    ("pddp_bnn_solves_per_sec_b128_bf16_mlp", False, "compute_dtype", 128),
    ("pddp_bnn_solves_per_sec_b128_bf16_matmul", False, "matmul_dtype",
     128))
# Lane-by-lane limits: float64 J relative (16a 1e-10; the BNN against the
# CPU 1e-8, its local model summing over 100 particles and 200 widths in
# another order), and the bf16 rows' J against float32 (pddp_tpu's
# tests/parallel/test_batch.py:141-170).
BATCHED_J_RTOL = {"cartpole": 1e-10, "bnn": 1e-8, "bf16": 0.05}


def _lane_ends(r):
    """The lanes' count of each end state, their mean evaluations and
    iterations, and whether every J is finite."""
    import torch
    names = {int(s): s.name for s in _ilqr().iLQRState}
    states = r.state.tolist()
    return {"states": {n: states.count(c) for c, n in names.items()
                       if c in states},
            "mean_evals": float(r.evals.double().mean()),
            "mean_iterations": float(r.iterations.double().mean()),
            "J_finite": bool(torch.isfinite(r.J_opt).all())}


def _ilqr():
    from pddp_tpu_torch.controllers import ilqr
    return ilqr


def _same_ends(a, b):
    import torch
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("state", "iterations", "evals"))


def _J_rel(a, b):
    """max over lanes of |J_a - J_b| / |J_b|."""
    Ja, Jb = a.J_opt.double().cpu(), b.J_opt.double().cpu()
    return float(((Ja - Jb).abs() / Jb.abs()).max())


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cartpole_batch(torch, dtype, device, B, N, seed=0):
    """bench.py's batch: z0 = 0.05 N(0, 1) per lane (numpy, ``seed``),
    U0 = 0.1, the cartpole at dt = 0.05."""
    model, cost, _ = cartpole_problem(torch, dtype, device, N)
    z0s = torch.as_tensor(
        0.05 * np.random.default_rng(seed).standard_normal((B, 4)),
        dtype=dtype, device=device)
    U0s = torch.full((B, N, 1), 0.1, dtype=dtype, device=device)
    return model, cost, z0s, U0s


def bnn_batch(torch, dtype, device, B, N, seed=7):
    """bench.py's BNN batch: the encoded start of phase 8, each lane
    offset by 0.01 N(0, 1) (numpy, ``seed``), U0 = 0.1."""
    from pddp_tpu_torch.encoding import StateEncoding, encode
    z0 = encode(torch.zeros(4, dtype=dtype, device=device),
                V=1e-2 * torch.ones(4, dtype=dtype, device=device),
                encoding=StateEncoding.UPPER_TRIANGULAR_CHOLESKY)
    off = np.random.default_rng(seed).standard_normal((B, z0.shape[-1]))
    z0s = z0 + torch.as_tensor(0.01 * off, dtype=dtype, device=device)
    return z0s, torch.full((B, N, 1), 0.1, dtype=dtype, device=device)


def evaluation_profile(model, cost, z0s, U0s, enc, cost_in_scan):
    """The device's activity (``device_profile``) over one batched
    evaluation of the scan path, the unit a batched solve repeats 11-15
    times: the plain backward and the line search over every lane, at the
    batch's first iterate (reg 10, the values do not change the work). A
    whole solve's hundreds of thousands of launches take minutes to read
    back from the profiler; one evaluation's take seconds."""
    from pddp_tpu_torch.controllers.ilqr import (backward, control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout)
    Z, AUX = rollout(model, z0s, U0s, enc)
    derivs = local_model(Z, U0s, AUX, model, cost, enc)
    alphas = default_fit_alphas(z0s.dtype, z0s.device)

    def evaluation():
        k, K, _ = backward(*derivs, reg=10.0)
        return control_law(model, derivs[0], U0s, k, K, alphas, enc,
                           cost=cost, with_aux=True,
                           cost_in_scan=cost_in_scan)
    return device_profile(evaluation)


def ends_and_J(a, b, lanes):
    """Lanes of ``a`` against the first ``lanes`` of ``b``: how many end
    otherwise (state, iterations or evaluations), and the largest J
    relative difference over the lanes that end the same and over the
    others (None where there are none)."""
    import torch
    same = ((a.state == b.state[:lanes]) & (a.iterations
            == b.iterations[:lanes]) & (a.evals == b.evals[:lanes]))
    rel = (a.J_opt - b.J_opt[:lanes]).abs() / b.J_opt[:lanes].abs()

    def most(mask):
        return float(rel[mask].max()) if bool(mask.any()) else None
    return {"lanes": lanes, "other_ends": int((~same).sum()),
            "J_rel_same_ends": most(same), "J_rel_other_ends": most(~same),
            "J_finite": bool(torch.isfinite(a.J_opt).all())}


def batched_k1_row(derivs, regs, label, launches):
    """K1 alone at a batch's shape and a reg per lane (CUDA events over
    raw launches) beside its bound and the plain backward's time, and its
    largest difference from the plain backward on these inputs over the
    lanes whose plain gains are finite (with ``ok`` equal in every
    lane)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import backward
    from pddp_tpu_torch.ops import backward_kernel as bk
    B, N, nz, nu = derivs[2].shape
    ms = events_ms(raw_k1(derivs, regs), 20)
    sweeps = k1_sweeps(derivs, regs)
    bound, by, roof, chain = chain_bound_ms(
        *k1_work(B, N, nz, nu, 4, sweeps=5 if sweeps is None else sweeps),
        "float32", k1_chain_cycles(nz, nu, "float32", sweeps), N)
    k_k, K_k, ok_k = bk.kernel_backward(*derivs, reg=regs)
    k_p, K_p, ok_p = backward(*derivs, reg=regs)
    errs = [rel_err(a[ok_p], b[ok_p]) for a, b in ((k_k, k_p), (K_k, K_p))]
    return {"kernel": "K1", "path": label, "B": B, "N": N, "nz": nz,
            "nu": nu, "ms": ms,
            "plain_ms": events_ms(lambda: backward(*derivs, reg=regs), 1,
                                  warmup=0),
            "bound_ms": bound, "bound_by": by, "roofline_ms": roof,
            "chain_floor_ms": chain, "launches": launches,
            "finite_lanes": int(ok_p.sum()),
            "ok_equal": bool(torch.equal(ok_k, ok_p)),
            "max_abs_err": max(e[0] for e in errs),
            "rel_err": max(e[1] for e in errs)}, (k_k, K_k, ok_p)


def cpu_references():
    """The CPU's side of the float64 checks of phases 14, 16 and 17, all
    on the CPU, so that it runs beside the build (phase 0) while the card
    is idle: phase 14's ``entry_point`` through the plain versions at every
    configuration of ENTRY_CASES, the unbatched ``solve`` of
    BATCHED_CPU_LANES lanes of 16a's batch, 16b's four BNN lanes (in
    chunks of two, 3 iterations), 17a's particle solves, 19c's
    constrained solves and 21d's quadrotor solve (in this worker: beside
    another worker's CPU solve, torch's CPU threads oversubscribe the
    host's cores), and 22d's lagged cartpole solve."""
    import torch
    entry = {label: entry_point(ex, codec, "cpu", torch.float64, "scan",
                                False) for label, ex, codec in ENTRY_CASES}
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.parallel import batched_solve
    B, N = BATCHED_B, BATCHED_H
    lanes = np.linspace(0, B - 1, BATCHED_CPU_LANES).astype(int).tolist()
    model, cost, z0s, U0s = cartpole_batch(torch, torch.float64, "cpu", B, N)
    opts = ILQROptions(**BATCHED_OPTS, cost_in_scan=True)
    cartpole = [(b, solve(model, cost, z0s[b], U0s[b], opts,
                          encoding=StateEncoding.IGNORE_UNCERTAINTY))
                for b in lanes]
    N = BNN_BATCH["N"]
    z, u = bnn_batch(torch, torch.float64, "cpu", 4, N)
    bnn = batched_solve(
        bnn_model(torch, torch.float64, N, True, device="cpu"),
        CartpoleCost(device="cpu", dtype=torch.float64), z, u,
        ILQROptions(n_iterations=3, max_evals=BATCHED_OPTS["max_evals"]),
        encoding=StateEncoding.UPPER_TRIANGULAR_CHOLESKY, chunk=2)
    return {"entry": entry, "cartpole": cartpole, "bnn": bnn,
            "particles": particle_cpu_solves(),
            "constrained": constrained_cpu_solves(),
            "traced": traced_cpu_solve(),
            "stateful": stateful_cpu_solve()}


def phase16a_cartpole(card, cpu):
    """16a: bench.py's batched cartpole solves (B=1024, H=200, 5
    iterations, 15 evaluations, the cost in the line search's loop) in
    float32, (i) with the bench's options (the scan backward and line
    search) and (ii) through K1 (a reg per lane) and K2(a); each timed
    once ((ii) after a warm-up and with every count from zero; the scan's
    launches ran in earlier phases, so it takes none, which saves 7 s).
    Then K1 and K2(a) alone at the batch's shape, the device's idle share
    of each run, and in float64 (ii) against (i) lane by lane and eight
    lanes against the CPU's unbatched ``solve`` (``cpu``, from
    ``cpu_references``)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions, control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.parallel import batched_solve
    ilqr = _ilqr()
    failed = []

    def want(cond, what):
        """A check, made after the phase's line is printed."""
        if not cond:
            failed.append(what)
    ign = StateEncoding.IGNORE_UNCERTAINTY
    B, N = BATCHED_B, BATCHED_H
    opts = {"scan": ILQROptions(**BATCHED_OPTS, cost_in_scan=True),
            "kernels": ILQROptions(**BATCHED_OPTS, cost_in_scan=True,
                                   riccati_mode="kernel",
                                   fused_rollout=True)}
    res = {"phase": "16a", "card": card, "B": B, "N": N, **BATCHED_OPTS}
    model, cost, z0s, U0s = cartpole_batch(torch, torch.float32, "cuda", B,
                                           N)

    def run(label):
        return batched_solve(model, cost, z0s, U0s, opts[label],
                             encoding=ign)

    t0 = time.perf_counter()
    out = {}
    for label in ("scan", "kernels"):
        if label == "kernels":
            run(label)  # warm-up
            bk.launches = bk.block_launches = 0
            reset_counts(fr.launches)
            ilqr.lane_evaluations = 0
        out[label], wall = _timed(lambda: run(label))
        if label == "kernels":
            counts = {"K1": bk.launches, "K1_block": bk.block_launches,
                      "K2(a)": fr.launches["a"],
                      "evaluations": ilqr.lane_evaluations}
        res[label] = {"wall_s": wall, **_lane_ends(out[label])}
    # Where the time goes: (i) one batched evaluation, (ii) a whole solve.
    res["scan"]["evaluation_profile"] = evaluation_profile(
        model, cost, z0s, U0s, ign, True)
    res["kernels"]["profile"] = device_profile(lambda: run("kernels"))
    res["batched_solves_per_sec_b1024_h200_5iter"] = B / res["scan"]["wall_s"]
    res["batched_solves_per_sec_b1024_h200_5iter_kernels"] = (
        B / res["kernels"]["wall_s"])
    res["launches"] = counts
    want(counts["K1"] >= 1 and counts["K1"] == counts["K2(a)"]
          == counts["evaluations"] and counts["K1_block"] == 0,
          "16a(ii) did not launch K1 and K2(a) once an evaluation: "
          "{}".format(counts))
    for label in ("scan", "kernels"):
        want(res[label]["J_finite"], "16a {}: non-finite J".format(label))

    # The kernels alone at the batch's shape, on the local model of its
    # first iterate, each lane's reg 10^U(1, 2): at this iterate Q_uu is
    # indefinite and a reg <= 1 gives non-finite gains (k2_inputs), and
    # later iterates' rollouts at the lanes' own mu leave float32's range
    # in some lanes.
    Z0, AUX0 = rollout(model, z0s, U0s, ign)
    derivs = local_model(Z0, U0s, AUX0, model, cost, ign)
    regs = torch.as_tensor(10.0**np.random.default_rng(16).uniform(
        1.0, 2.0, B), dtype=torch.float32, device="cuda")
    k1, (k, K, fin) = batched_k1_row(derivs, regs, "cartpole_b1024",
                                     counts["K1"])
    alphas = default_fit_alphas(torch.float32, "cuda")
    A = alphas.shape[0]
    Z_k, U_k, J_k = (t[fin] for t in fr.fused_control_law(
        model, derivs[0], U0s, k, K, alphas, ign, cost=cost))
    Z_p, U_p, J_p = (t[fin] for t in control_law(
        model, derivs[0], U0s, k, K, alphas, ign, cost=cost,
        cost_in_scan=True))
    bound, by, roof, chain = chain_bound_ms(
        *k2_work(B, N, A, 4, False), "float32",
        k2_chain_cycles("cartpole", 4, 4, "float32"), N)
    k2 = {"kernel": "K2(a)", "path": "cartpole_b1024", "B": B, "N": N,
          "A": A, "ms": events_ms(raw_k2(model, cost, derivs[0], U0s, k, K,
                                         alphas), 20),
          "plain_ms": events_ms(lambda: control_law(
              model, derivs[0], U0s, k, K, alphas, ign, cost=cost,
              cost_in_scan=True), 1, warmup=0),
          "bound_ms": bound, "bound_by": by, "roofline_ms": roof,
          "chain_floor_ms": chain, "launches": counts["K2(a)"],
          "max_abs_err": max(rel_err(Z_k, Z_p)[0], rel_err(U_k, U_p)[0],
                             rel_err(J_k, J_p)[0]),
          "rel_err": max(rel_err(Z_k, Z_p)[1], rel_err(U_k, U_p)[1],
                         rel_err(J_k, J_p)[1])}
    res["kernel_rows"] = [k1, k2]
    want(k1["ok_equal"] and k1["finite_lanes"] == B
         and k1["rel_err"] <= TOL[("K1", "float32")]
         and k2["rel_err"] <= TOL[("K2", "float32")],
         "16a: K1 or K2(a) off its plain version at the batch: {} {}"
         .format(k1, k2))

    # float64: (ii) against (i) lane by lane, and lanes against the CPU.
    model, cost, z0s, U0s = cartpole_batch(torch, torch.float64, "cuda", B,
                                           N)
    f64 = {label: run(label) for label in ("scan", "kernels")}
    k64 = f64["kernels"]
    cpu_rows = [{"lane": b, "state": int(s.state), "iterations": s.iterations,
                 "evals": s.evals,
                 "card": [int(k64.state[b]), int(k64.iterations[b]),
                          int(k64.evals[b])],
                 "J_rel": abs(float(k64.J_opt[b]) - s.J_opt) / abs(s.J_opt)}
                for b, s in cpu["cartpole"]]
    res["float64"] = {"kernels_vs_scan_same_ends": _same_ends(
        f64["kernels"], f64["scan"]),
        "kernels_vs_scan_J_rel": _J_rel(f64["kernels"], f64["scan"]),
        "scan": _lane_ends(f64["scan"]), "cpu_lanes": cpu_rows}
    want(res["float64"]["kernels_vs_scan_same_ends"]
          and res["float64"]["kernels_vs_scan_J_rel"]
          <= BATCHED_J_RTOL["cartpole"],
          "16a float64: kernels and scan lanes part: {}".format(
              res["float64"]))
    for row in cpu_rows:
        want(row["card"] == [row["state"], row["iterations"], row["evals"]]
              and row["J_rel"] <= BATCHED_J_RTOL["cartpole"],
              "16a float64: a lane off the CPU's solve: {}".format(row))
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    check(not failed, "; ".join(failed))
    return res


def phase16b_bnn(card, cpu):
    """16b: bench.py's batched BNN solves (6-200-200-8, P=100, the
    Cholesky codec, N=25, B=1024 in chunks of 256, 5 iterations, 15
    evaluations) in float32, the rows of BNN_BATCH_ROWS each timed once,
    with its lanes' mean evaluations and iterations, the device's idle
    share of one batched evaluation of its first chunk and the peak memory
    of its run. Checks: K2(d) is launched by no row (pddp_tpu's gate keeps
    the stateful model on the scan); one chunk under
    riccati_mode="kernel" launches K1 at nz=14, B=256 once an evaluation,
    and on one batched evaluation its gains and the line search's J on
    them are within phase 8's float32 tolerances of the plain backward's;
    the bf16 rows' J within 5 % of float32's on the lanes that end alike;
    four lanes in float64 (in chunks of two, 3 iterations) through K1 on
    the card against the scan on the CPU (``cpu``, from
    ``cpu_references``). Lanes whose float32 or bfloat16 solves end
    otherwise (another number of accepted steps, where rounding tips an
    accept) are counted, with their J gap, for ROADMAP.md's C."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions, backward,
                                                 control_law,
                                                 default_fit_alphas,
                                                 local_model)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    from pddp_tpu_torch.parallel import batched_solve
    ilqr = _ilqr()
    failed = []

    def want(cond, what):
        """A check, made after the phase's line is printed."""
        if not cond:
            failed.append(what)
    t0 = time.perf_counter()
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    B, C, N = BNN_BATCH["B"], BNN_BATCH["chunk"], BNN_BATCH["N"]
    opts = ILQROptions(**BATCHED_OPTS)
    res = {"phase": "16b", "card": card, **BNN_BATCH, **BATCHED_OPTS,
           "rows": {}}
    cost = CartpoleCost(device="cuda", dtype=torch.float32)
    z0s, U0s = bnn_batch(torch, torch.float32, "cuda", B, N)
    k2d = fb.launches["rollout"]
    runs = {}
    for name, trained, knob, Bn in BNN_BATCH_ROWS:
        kw = {} if knob is None else {knob: torch.bfloat16}
        model = bnn_model(torch, torch.float32, N, trained, **kw)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs[name], wall = _timed(lambda: batched_solve(
            model, cost, z0s[:Bn], U0s[:Bn], opts, encoding=ch,
            chunk=min(C, Bn)))
        row = {"B": Bn, "wall_s": wall, name: Bn / wall,
               **_lane_ends(runs[name]),
               "peak_memory_bytes": torch.cuda.max_memory_allocated() - base,
               "evaluation_profile": evaluation_profile(
                   model, cost, z0s[:C], U0s[:C], ch, False)}
        res["rows"][name] = row
        res[name] = row[name]
        want(row["J_finite"], "16b {}: non-finite J".format(name))
        if trained:
            trained_model = model
    res["K2(d)_launches"] = fb.launches["rollout"] - k2d
    want(res["K2(d)_launches"] == 0,
          "a batched BNN solve launched K2(d): {}".format(
              res["K2(d)_launches"]))
    f32 = runs[BNN_BATCH_ROWS[1][0]]
    for name, _, _, Bn in BNN_BATCH_ROWS[2:]:
        cmp = ends_and_J(runs[name], f32, Bn)
        res["rows"][name]["against_float32"] = cmp
        want(cmp["J_finite"] and cmp["J_rel_same_ends"] is not None
             and cmp["J_rel_same_ends"] <= BATCHED_J_RTOL["bf16"],
             "16b {}: J off float32's: {}".format(name, cmp))

    # matmul_dtype's product on the card: one cuBLAS call of bfloat16
    # operands with a float32 out (torch.mm(..., out_dtype=)), the operands
    # cast first, at the line search's widest product (a chunk's 256 lanes
    # x 10 candidates x 100 particles, 200 x 200), beside float32's.
    from pddp_tpu_torch.models.bnn.network import _low_precision_mm
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((C * 10 * 100, 200), device="cuda", generator=gen)
    W = torch.randn((200, 200), device="cuda", generator=gen)
    res["matmul_dtype_product"] = {
        "shape": [C * 10 * 100, 200, 200],
        "bf16_operands_float32_out_ms": events_ms(
            lambda: _low_precision_mm(x, W, torch.bfloat16), 20),
        "float32_ms": events_ms(lambda: x @ W, 20),
        "out_dtype": str(_low_precision_mm(x, W, torch.bfloat16).dtype)}
    want(res["matmul_dtype_product"]["out_dtype"] == "torch.float32",
         "16b: matmul_dtype's product is not float32")

    # One chunk through K1 at nz=14, B=256 against the scan chunk. Over a
    # whole float32 solve a lane's path may part from the scan's (an
    # accept tipped by rounding; ROADMAP.md C), so the check is made on
    # one batched evaluation, state-free: K1's gains and the line
    # search's J per candidate on them, against the plain backward's, at
    # the chunk's first iterate with a reg per lane 10^U(0, 1) (the
    # tolerances of phase 8, which makes the same comparison at B=1).
    scan = runs[BNN_BATCH_ROWS[0][0]]
    bk.launches = bk.block_launches = 0
    ilqr.lane_evaluations = 0
    kern = batched_solve(trained_model, cost, z0s[:C], U0s[:C],
                         ILQROptions(**BATCHED_OPTS, riccati_mode="kernel"),
                         encoding=ch)
    torch.cuda.synchronize()
    counts = {"K1": bk.launches, "K1_block": bk.block_launches,
              "evaluations": ilqr.lane_evaluations}
    Z, AUX = ilqr.rollout(trained_model, z0s[:C], U0s[:C], ch)
    derivs = local_model(Z, U0s[:C], AUX, trained_model, cost, ch)
    regs = torch.as_tensor(10.0**np.random.default_rng(17).uniform(
        0.0, 1.0, C), dtype=torch.float32, device="cuda")
    k1, (k, K, fin) = batched_k1_row(derivs, regs, "bnn_chunk_b256",
                                     counts["K1"])
    kp, Kp, _ = backward(*derivs, reg=regs)
    alphas = default_fit_alphas(torch.float32, "cuda")
    J_k, J_p = (control_law(trained_model, derivs[0], U0s[:C], a, b, alphas,
                            ch, cost=cost)[2][fin] for a, b in
                ((k, K), (kp, Kp)))
    J_rel = float(((J_k - J_p).abs() / J_p.abs()).max())
    res["kernel_chunk"] = {"launches": counts,
                           "evaluation_J_rel": J_rel,
                           "solve_against_scan": ends_and_J(kern, scan, C),
                           **_lane_ends(kern)}
    res["kernel_rows"] = [k1]
    want(counts["K1"] >= 1 and counts["K1"] == counts["evaluations"]
         and counts["K1_block"] == 0 and k1["nz"] == 14 and k1["B"] == C,
         "16b: the kernel chunk's K1 launches: {}".format(counts))
    want(k1["ok_equal"] and k1["finite_lanes"] == C
         and k1["rel_err"] <= TOL[("K1", "float32")]
         and J_rel <= BNN_TOL["float32_J_N25"]
         and res["kernel_chunk"]["J_finite"],
         "16b: the kernel chunk off the plain backward: {} {}".format(
             k1, res["kernel_chunk"]))

    # float64: four lanes in chunks of two, 3 iterations, through K1 on
    # the card against the scan on the CPU.
    z, u = bnn_batch(torch, torch.float64, "cuda", 4, N)
    n = bk.launches
    ends = [batched_solve(
        bnn_model(torch, torch.float64, N, True),
        CartpoleCost(device="cuda", dtype=torch.float64), z, u,
        ILQROptions(n_iterations=3, max_evals=BATCHED_OPTS["max_evals"],
                    riccati_mode="kernel"),
        encoding=ch, chunk=2), cpu["bnn"]]
    res["float64_lanes"] = {"same_ends": _same_ends(*ends),
                            "J_rel": _J_rel(*ends),
                            "K1_launches": bk.launches - n,
                            **_lane_ends(ends[1])}
    want(res["float64_lanes"]["same_ends"]
         and res["float64_lanes"]["K1_launches"] >= 1
         and res["float64_lanes"]["J_rel"] <= BATCHED_J_RTOL["bnn"],
         "16b float64: the card's lanes off the CPU's: {}".format(
             res["float64_lanes"]))
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    check(not failed, "; ".join(failed))
    return res


def phase16_batched(card, cpu):
    """Phase 16, batched solves: 16a, 16b; ``cpu`` the CPU's side of
    their float64 checks (``cpu_references``)."""
    t0 = time.perf_counter()
    out = {"a": phase16a_cartpole(card, cpu), "b": phase16b_bnn(card, cpu)}
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": 16, "seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# Phase 17: the particle model (particulate_model) solved through K1
# ---------------------------------------------------------------------------

# particulate_model's defaults, 100 particles and a horizon of 100, and the
# solves' N, cut to 50 of the horizon for the run's time.
PARTICLE_P, PARTICLE_H, PARTICLE_N = 100, 100, 50
# Every solve's depth (iterations, evaluations), cut for the run's time.
PARTICLE_OPTS = {"n_iterations": 3, "max_evals": 6}
# (label, example, codec, constrained). 17a, the first four: the cartpole
# at the warp kernel's (8, 1) and (14, 1) and the block kernel's nz = 20,
# and under Cholesky with its actions squashed into [-PDDP_UMAX, PDDP_UMAX]
# by constrain_model; 17b: the rendezvous under Cholesky, nz = 44, nu = 4,
# the block kernel with its clamp.
PARTICLE_ROWS = (
    ("cartpole_variance", "cartpole", "VARIANCE_ONLY", False),
    ("cartpole_chol", "cartpole", "UPPER_TRIANGULAR_CHOLESKY", False),
    ("cartpole_full", "cartpole", "FULL_COVARIANCE_MATRIX", False),
    ("cartpole_chol_constrained", "cartpole", "UPPER_TRIANGULAR_CHOLESKY",
     True),
    ("rendezvous_chol", "rendezvous", "UPPER_TRIANGULAR_CHOLESKY", False),
)
PARTICLE_17A = 4
# 17a in float64, the card's solve through K1 against the CPU's plain one:
# the same arithmetic in another order of sums, over at most 10
# evaluations.
PARTICLE_TOL = {"J_rtol": 1e-10, "rtol": 1e-8}
# The regs K1's check on a row's first local model tries in turn, from
# that of phase 1's clamp cases up to ILQROptions' max_reg, as a solve
# escalates its own: at small regs the recursion can overflow there (at
# N=100 the Cholesky rows in float32 at every reg, the constrained row in
# both types below 1e3).
PARTICLE_K1_REGS = tuple(10.0**k for k in range(1, 11))


def particle_problem(label, device, dtype):
    """(model, cost, z0, U0) of PARTICLE_ROWS' row ``label``:
    ``particulate_model`` of the example's model (``constrain_model``'s
    where the row says so) with PARTICLE_P particles over PARTICLE_H steps,
    its noise the standard normal draws of numpy seed 17 (the same on the
    card and the CPU); the start x0 of EXAMPLES with covariance 1e-2 I;
    U0 (PARTICLE_N, nu) 0.1 N(0, 1) from numpy seed 18."""
    import importlib

    import torch
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.utils.constraint import constrain_model
    from pddp_tpu_torch.utils.particles import particulate_model
    _, ex, codec, constrained = next(r for r in PARTICLE_ROWS
                                     if r[0] == label)
    mod, model_cls, cost_cls, x0, dt, _ = EXAMPLES[ex]
    m = importlib.import_module("pddp_tpu_torch.examples." + mod)
    cls = getattr(m, model_cls)
    if constrained:
        cls = constrain_model(-PDDP_UMAX, PDDP_UMAX)(cls)
    inner = cls(dt=dt, device=device, dtype=dtype)
    eps = np.random.default_rng(17).standard_normal(
        (PARTICLE_H, PARTICLE_P, inner.state_size))
    model = particulate_model(inner, eps=eps, n_particles=PARTICLE_P,
                              horizon=PARTICLE_H)
    U0 = torch.as_tensor(0.1 * np.random.default_rng(18).standard_normal(
        (PARTICLE_N, inner.action_size)), dtype=dtype, device=device)
    z0 = start_state(torch.tensor(x0, dtype=dtype, device=device),
                     StateEncoding[codec])
    return model, getattr(m, cost_cls)(device=device, dtype=dtype), z0, U0


def particle_cpu_solves():
    """17a's float64 solves on the CPU through the plain versions (for
    ``cpu_references``), and under "f32_cartpole_chol" the float32 local
    model of the cartpole's Cholesky row on the CPU with the plain
    backward's ok at each reg of PARTICLE_K1_REGS (``particle_f32_report``)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions, backward,
                                                 local_model, rollout, solve)
    from pddp_tpu_torch.encoding import StateEncoding
    out = {}
    for label, _, codec, _ in PARTICLE_ROWS[:PARTICLE_17A]:
        model, cost, z0, U0 = particle_problem(label, "cpu", torch.float64)
        out[label] = solve(model, cost, z0, U0,
                           ILQROptions(**PARTICLE_OPTS),
                           encoding=StateEncoding[codec])
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    model, cost, z0, U0 = particle_problem("cartpole_chol", "cpu",
                                           torch.float32)
    Z, AUX = rollout(model, z0, U0, ch)
    derivs = local_model(Z, U0, AUX, model, cost, ch)
    out["f32_cartpole_chol"] = {
        "derivs": derivs,
        "ok": [bool(backward(*derivs, reg=reg)[2])
               for reg in PARTICLE_K1_REGS]}
    return out


# pddp_tpu's float32 particle cartpole under the Cholesky codec at phase
# 17's size and seeds (tests/golden/particle_f32.py).
PARTICLE_F32 = os.path.join(ROOT, "tests", "golden", "particle_f32.npz")
LOCAL_NAMES = ("Z", "F_z", "F_u", "L", "L_z", "L_u", "L_zz", "L_uz", "L_uu")


def particle_f32_report(Z, derivs, r, cpu):
    """The float32 Cholesky particle row against pddp_tpu's stored run:
    the plain backward's ok at each reg of PARTICLE_K1_REGS on the card,
    on the CPU (``cpu``) and in pddp_tpu; the card's rollout of U0 against
    pddp_tpu's; each array of the card's local model against the CPU's
    (largest difference over largest value, whether it is finite, and the
    steps where the card's is not); the solve's ends on the card beside
    pddp_tpu's. ``held``: the card's gains are finite at every reg where
    pddp_tpu's are (at every one: its stored run), as the CPU's are; on
    the card the first rung of the cost's augmented covariance fails at
    step 4, so this holds only while a failed rung carries no derivative
    (``utils.linalg.safe_cholesky``)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import backward, iLQRState
    with np.load(PARTICLE_F32) as npz:
        ref = dict(npz)
    local = {}
    for name, a, b in zip(LOCAL_NAMES, derivs, cpu["derivs"]):
        a = a.detach().cpu()
        fin = torch.isfinite(a).reshape(a.shape[0], -1).all(dim=-1)
        local[name] = {"rel": rel_err(a.double(), b.double())[1],
                       "finite_card": bool(fin.all()),
                       "finite_cpu": bool(torch.isfinite(b).all()),
                       "nonfinite_steps_card": (~fin).nonzero().flatten()
                       .tolist()}
    ok = {"card": [bool(backward(*derivs, reg=reg)[2])
                   for reg in PARTICLE_K1_REGS],
          "cpu": cpu["ok"], "pddp_tpu": [bool(v) for v in ref["ok"]]}
    return {"ok_per_reg": ok,
            "held": ok["card"] == ok["pddp_tpu"] == ok["cpu"],
            "Z_vs_pddp_tpu": rel_err(Z.cpu().double(),
                                     torch.as_tensor(ref["Z"]).double()),
            "local_model_card_vs_cpu": local,
            "solve": {"card": _ends(r),
                      "pddp_tpu": {"state": iLQRState(
                                       int(ref["solve_state"])).name,
                                   "iterations": int(ref["solve_iterations"]),
                                   "evals": int(ref["solve_evals"]),
                                   "J": float(ref["solve_J"])}}}


def particle_k1_check(derivs):
    """K1 against its plain version on one local model of a particle row,
    in the model's type, at the first reg of PARTICLE_K1_REGS at which the
    plain recursion stays finite, under phase 1's tolerances: the warp
    kernel's TOL against the plain version of its type; the block kernel's
    K1_BLOCK_TOL against float64, in float32 widened to twice the float32
    plain version's own error within K1_BLOCK_F32_CAP. Where no reg keeps
    it finite, ``held`` is False and only ``ok`` is compared."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import backward
    from pddp_tpu_torch.ops import backward_kernel as bk
    for reg in PARTICLE_K1_REGS:
        k_p, K_p, ok_p = backward(*derivs, reg=reg)
        if bool(ok_p):
            break
    N, nz, nu = derivs[2].shape
    dname = str(derivs[0].dtype).replace("torch.", "")
    block = (nz, nu) not in bk.INSTANCES
    n = (bk.launches, bk.block_launches)
    k_k, K_k, ok_k = bk.kernel_backward(*derivs, reg=reg)
    torch.cuda.synchronize()
    launched = (bk.block_launches if block else bk.launches) == n[block] + 1
    bk.launches, bk.block_launches = n
    row = {"dtype": dname, "reg": reg, "launched": launched,
           "ok_equal": bool(ok_k) == bool(ok_p), "held": bool(ok_p)}
    if not row["held"]:
        row["pass"] = row["launched"] and row["ok_equal"]
        return row
    errs = [rel_err(k_k, k_p), rel_err(K_k, K_p)]
    row.update(max_abs_err=max(e[0] for e in errs),
               kernel_vs_plain_rel=max(e[1] for e in errs))
    if block and dname == "float32":
        k64, K64, _ = backward(*(t.double() for t in derivs), reg=reg)
        plain = max(rel_err(k_p.double(), k64)[1],
                    rel_err(K_p.double(), K64)[1])
        row.update(plain_float32_rel=plain,
                   rel=max(rel_err(k_k.double(), k64)[1],
                           rel_err(K_k.double(), K64)[1]),
                   tol=max(k1_block_tol(dname, nu), 2.0 * plain))
        ok = (row["rel"] <= row["tol"] and plain <= K1_BLOCK_F32_CAP
              and row["kernel_vs_plain_rel"] <= K1_BLOCK_F32_CAP)
    else:
        row.update(rel=row["kernel_vs_plain_rel"],
                   tol=k1_block_tol(dname, nu) if block
                   else TOL[("K1", dname)])
        ok = row["rel"] <= row["tol"]
    row["pass"] = ok and launched and row["ok_equal"] and bool(ok_k)
    return row


def particle_k1_times(derivs, reg, launches):
    """K1 alone on a particle row's float32 local model at ``reg`` (CUDA
    events over 200 raw launches) beside its bound, the larger of the
    roofline and the chain floor at this N (the clamp's sweeps those the
    data needs), and the plain backward's time (one call)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import backward
    from pddp_tpu_torch.ops import backward_kernel as bk
    N, nz, nu = derivs[2].shape
    block = (nz, nu) not in bk.INSTANCES
    sweeps = k1_sweeps(derivs, reg)
    bound, by, roof, chain = chain_bound_ms(
        *k1_work(1, N, nz, nu, 4, sweeps=5 if sweeps is None else sweeps),
        "float32", k1_chain_cycles(nz, nu, "float32", sweeps), N)
    row = {"kernel": "K1 " + ("block" if block else "warp"), "B": 1,
           "N": N, "nz": nz, "nu": nu, "reg": reg, "launches": launches,
           "ms": events_ms(raw_k1(derivs, reg), 200),
           "plain_ms": events_ms(lambda: backward(*derivs, reg=reg), 1,
                                 warmup=0),
           "bound_ms": bound, "bound_by": by, "roofline_ms": roof,
           "chain_floor_ms": chain, "clamp_sweeps": sweeps}
    if block:
        row["plan"] = bk.launch_plan(nz, nu, torch.float32, 1)
    return row


def _ends(r):
    return {"state": r.state.name, "iterations": r.iterations,
            "evals": r.evals, "J": float(r.J_opt)}


def phase17_particles(card, cpu):
    """Phase 17, the particle model: ``solve(particulate_model(...), cost,
    z0, U0, riccati_mode="kernel", fused_rollout=True)`` at PARTICLE_P
    particles and horizon PARTICLE_H, N=PARTICLE_N, on every row of
    PARTICLE_ROWS in
    float32, each count from zero, timed by the port's ``PhaseTimer``;
    K1 takes every backward and the line search stays on the scan (the
    model is stateful, as in pddp_tpu's gate). On each row's first local
    model, K1 alone (``particle_k1_times``) and against its plain version
    (``particle_k1_check``; 17a also on its float64 model). 17a also
    solves through the plain backward (reported: a float32 solve may take
    another path) and in float64 through K1 against the CPU's plain solve
    (``cpu``, from ``cpu_references``): the same ends, J within
    PARTICLE_TOL's 1e-10 relative, Z and U within 1e-8 of their largest
    entry."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions, local_model,
                                                 rollout, solve)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.utils.profiling import PhaseTimer
    failed = []

    def want(cond, what):
        if not cond:
            failed.append(what)
    t_start = time.perf_counter()
    timer = PhaseTimer()
    local_models = {}  # phase 19's line searches start from these
    opts = {mode: ILQROptions(**PARTICLE_OPTS, riccati_mode=mode,
                              fused_rollout=True)
            for mode in ("kernel", "scan")}
    rows = []
    for r_i, (label, ex, codec, constrained) in enumerate(PARTICLE_ROWS):
        enc = StateEncoding[codec]
        model, cost, z0, U0 = particle_problem(label, "cuda", torch.float32)
        with timer(label + " local model"):
            Z, AUX = rollout(model, z0, U0, enc)
            derivs = local_model(Z, U0, AUX, model, cost, enc)
        local_models[label] = {"float32": derivs}
        bk.launches = bk.block_launches = 0
        reset_counts(fr.launches)
        reset_counts(fpr.launches)
        with timer(label + " solve, K1"):
            r = solve(model, cost, z0, U0, opts["kernel"], encoding=enc)
        counts = {"K1_warp": bk.launches, "K1_block": bk.block_launches,
                  "K2": sum(fr.launches.values()) + fpr.launches["rollout"]}
        if label == "cartpole_chol":
            with timer(label + " against pddp_tpu's float32"):
                f32_report = particle_f32_report(Z, derivs, r,
                                                 cpu["f32_cartpole_chol"])
            want(f32_report["held"],
                 "{}: the card's float32 gains are not finite at every reg "
                 "where pddp_tpu's are: {}".format(
                     label, f32_report["ok_per_reg"]))
        with timer(label + " K1 check and times"):
            checks = {"float32": particle_k1_check(derivs)}
            k1 = particle_k1_times(derivs, checks["float32"]["reg"],
                                   counts["K1_warp"] + counts["K1_block"])
        row = {"path": label, "example": ex, "codec": codec,
               "constrained": constrained, "P": PARTICLE_P,
               "horizon": PARTICLE_H, "N": PARTICLE_N, "nz": z0.shape[-1],
               "nu": U0.shape[-1], "float32": _ends(r),
               "launches": counts, "K1": k1, "K1_checks": checks,
               "wall_ms": 1e3 * timer.totals[label + " solve, K1"]}
        block = k1["kernel"] == "K1 block"
        want(counts["K1_block" if block else "K1_warp"] == r.evals >= 1
             and counts["K1_warp" if block else "K1_block"] == 0
             and counts["K2"] == 0,
             "{}: K1 not launched once an evaluation, or K2 launched: {} "
             "for {} evaluations".format(label, counts, r.evals))
        want(np.isfinite(row["float32"]["J"])
             and bool(torch.isfinite(r.Z).all()),
             "{}: non-finite float32 solve: {}".format(label, row["float32"]))
        if r_i < PARTICLE_17A:
            with timer(label + " solve, plain backward"):
                rp = solve(model, cost, z0, U0, opts["scan"], encoding=enc)
            row["plain_backward"] = {
                **_ends(rp), "wall_ms": 1e3 * timer.totals[
                    label + " solve, plain backward"],
                "same_ends": (rp.state, rp.iterations, rp.evals)
                == (r.state, r.iterations, r.evals),
                "J_rel": abs(float(r.J_opt) - float(rp.J_opt))
                / abs(float(rp.J_opt))}
            model, cost, z0, U0 = particle_problem(label, "cuda",
                                                   torch.float64)
            with timer(label + " float64 K1 check"):
                Z, AUX = rollout(model, z0, U0, enc)
                local_models[label]["float64"] = local_model(
                    Z, U0, AUX, model, cost, enc)
                checks["float64"] = particle_k1_check(
                    local_models[label]["float64"])
            bk.launches = bk.block_launches = 0
            with timer(label + " float64 solve, K1"):
                r64 = solve(model, cost, z0, U0, opts["kernel"],
                            encoding=enc)
            c = cpu[label]
            row["float64"] = {
                **_ends(r64), "cpu": _ends(c),
                "K1_launches": bk.launches + bk.block_launches,
                "J_rel": abs(r64.J_opt - c.J_opt) / abs(c.J_opt),
                "Z_rel": rel_err(r64.Z.cpu(), c.Z)[1],
                "U_rel": rel_err(r64.U.cpu(), c.U)[1]}
            f = row["float64"]
            want((r64.state, r64.iterations, r64.evals)
                 == (c.state, c.iterations, c.evals)
                 and f["K1_launches"] == r64.evals
                 and f["J_rel"] <= PARTICLE_TOL["J_rtol"]
                 and f["Z_rel"] <= PARTICLE_TOL["rtol"]
                 and f["U_rel"] <= PARTICLE_TOL["rtol"],
                 "{}: the float64 solve through K1 differs from the CPU's: "
                 "{}".format(label, f))
        for c in checks.values():
            want(c["pass"], "{}: K1 off its plain version: {}".format(
                label, checks))
        want(any(c["held"] for c in checks.values()),
             "{}: K1 held on no local model: {}".format(label, checks))
        held = [c for c in checks.values() if c["held"]]
        k1["max_abs_err"] = held[0]["max_abs_err"] if held else None
        k1["max_abs_err_dtype"] = held[0]["dtype"] if held else None
        rows.append(row)
        emit({"phase": "17a" if r_i < PARTICLE_17A else "17b",
              "card": card, **row})
    res = {"phase": 17, "rows": rows, "options": PARTICLE_OPTS,
           "timer_ms": {k: 1e3 * v for k, v in timer.totals.items()},
           "seconds": time.perf_counter() - t_start,
           "local_models": local_models}
    emit({"phase": 17, "seconds": res["seconds"],
          "timer_ms": res["timer_ms"],
          "float32_cholesky_vs_pddp_tpu": f32_report})
    check(not failed, "; ".join(failed))
    return res


# ---------------------------------------------------------------------------
# Phase 18: multi-GPU on torch.distributed
# ---------------------------------------------------------------------------

# Ranks of the spawned gloo world. The machine has one card and NCCL takes
# one rank a device, so this world puts both ranks on cuda:0: its
# collectives cross processes while the kernels run on the card.
SHARD_RANKS = 2
# The sharded batch against one unsharded batched_solve:
# pddp_tpu's tests/parallel/test_batch.py:38-39.
SHARD_BATCH_TOL = {"J_rtol": 1e-5, "U_rtol": 1e-4, "U_atol": 1e-6}
# The particle-sharded solve in float64 against the unsharded one:
# tests/parallel/test_particles.py:48-51 (the ends equal).
PSOLVE_TOL = {"J_rtol": 1e-9, "ZU_rtol": 1e-7, "ZU_atol": 1e-10,
              "K_rtol": 1e-6, "K_atol": 1e-8}
# A BNN solve's depth: phase 9's 15 evaluations at most, its 5 iterations
# cut to 2 for the run's time (phase 18 runs five such solves; at 5
# iterations they took 10 evaluations and 4-6 s each alone, 6-9 s each in
# the 2-rank world).
PSOLVE_OPTS = {"n_iterations": 2, "max_evals": 15}
# One data-parallel AMSGrad step of fit_bnn's (its batch of 128 rows,
# phase 15's learning rate) on the trained net in float64, against one
# step on the whole batch in one process: the same sums in another order.
DP_ROWS, DP_SEED = 128, 18
DP_TOL = {"params_atol": 1e-10, "loss_rtol": 1e-12}
ENDS = ("state", "iterations", "evals")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host(r, fields=("J_opt", "U", "state", "iterations", "evals")):
    """An ILQRResult's ``fields`` as numpy arrays (numbers as they are):
    what a rank sends back by pickle (a tensor on a queue would be shared
    through a file descriptor of a process that exits)."""
    import torch
    return {f: (getattr(r, f).cpu().numpy() if isinstance(getattr(r, f),
                                                          torch.Tensor)
                else getattr(r, f)) for f in fields}


def dp_problem(torch, dtype):
    """(model, loss_fn, params, batch) of the data-parallel step: the
    trained net of phase 8, DP_ROWS of cartpole_transitions' rows (numpy,
    DP_SEED) normalized by the net's buffers, and training noise drawn by
    numpy for each hidden layer (concrete dropout's uniform)."""
    from pddp_tpu_torch.models.bnn import training_loss
    from pddp_tpu_torch.utils.angular import augment_state
    model = bnn_model(torch, dtype, BNN_BATCH["N"], True)
    rng = np.random.default_rng(DP_SEED)
    X, U, dX = cartpole_transitions(rng, DP_ROWS, "cuda", dtype)
    x = model._normalize_input(torch.cat([augment_state(
        X, model.angular_indices, model.non_angular_indices),
        model._constrain(U)], dim=-1))
    noise = [torch.as_tensor(rng.uniform(1e-5, 1.0 - 1e-5,
                                         (DP_ROWS, layer.W.shape[1])),
                             dtype=dtype, device="cuda")
             for layer in model.net.layers[:-1]]
    loss_fn, params = training_loss(
        model, n_data=torch.tensor(float(DP_ROWS), dtype=dtype,
                                   device="cuda"))
    return model, loss_fn, params, {"x": x, "dX": dX, "noise": noise}


def shard_paths(size):
    """The three sharded paths in one rank of a world of ``size`` ranks
    (its process group started): (i) the cartpole batch of 16a sharded
    over the ranks through K1 and K2(a), timed after a warm-up, with the
    rank's launches; (ii) the particle-sharded solve of phase 8's trained
    BNN through K1 in float64 and, timed, float32, with the rank's
    launches and its first local model (float32); (iii) one
    ``dp_train_step`` of AMSGrad (float64). Every count is set to 0 just
    before each path and read just after."""
    import torch
    from pddp_tpu_torch.controllers import ilqr
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions, local_model,
                                                 rollout)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.parallel import (batched_solve, dp_train_step,
                                         make_mesh, particle_sharded_solve)
    from pddp_tpu_torch.parallel.particles import _local_ensemble
    from pddp_tpu_torch.utils.optim import amsgrad

    def zero():
        bk.launches = bk.block_launches = 0
        reset_counts(fr.launches)
        reset_counts(fb.launches)
        ilqr.lane_evaluations = 0

    def counts():
        return {"K1": bk.launches, "K1_block": bk.block_launches,
                "K2(a)": fr.launches["a"],
                "K2_other": sum(fr.launches.values()) - fr.launches["a"],
                "K2(d)": fb.launches["rollout"],
                "evaluations": ilqr.lane_evaluations}

    out = {"ranks": size, "rank": torch.distributed.get_rank(),
           "backend": torch.distributed.get_backend()}
    dp = make_mesh("dp")
    model, cost, z0s, U0s = cartpole_batch(torch, torch.float32, "cuda",
                                           BATCHED_B, BATCHED_H)
    opts = ILQROptions(**BATCHED_OPTS, cost_in_scan=True,
                       riccati_mode="kernel", fused_rollout=True)

    def batch():
        return batched_solve(model, cost, z0s, U0s, opts,
                             encoding=StateEncoding.IGNORE_UNCERTAINTY,
                             mesh=dp)
    batch()   # warm-up
    zero()
    r, wall = _timed(batch)
    out["batch"] = {"wall_s": wall, "launches": counts(),
                    "lanes_a_rank": BATCHED_B // size, "result": _host(r)}

    pp = make_mesh("pp")
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    N = BNN_BATCH["N"]
    for dtype in (torch.float64, torch.float32):
        m = bnn_model(torch, dtype, N, True)
        c = CartpoleCost(device="cuda", dtype=dtype)
        z0, U0 = bnn_start(torch, dtype, N)
        popts = ILQROptions(**PSOLVE_OPTS, riccati_mode="kernel")
        zero()
        r, wall = _timed(lambda: particle_sharded_solve(
            m, c, z0, U0, popts, encoding=ch, mesh=pp))
        key = "psolve_" + str(dtype).replace("torch.", "")
        out[key] = {"wall_s": wall, "launches": counts(),
                    "particles_a_rank": m.n_particles // size,
                    "result": _host(r, ("Z", "U", "K", "J_opt", "state",
                                        "iterations", "evals"))}
    local = _local_ensemble(m, pp.get_group("pp"))
    Z, AUX = rollout(local, z0, U0, ch)
    out["psolve_float32"]["first_local_model"] = [
        t.cpu().numpy() for t in local_model(Z, U0, AUX, local, c, ch)]

    _, loss_fn, params, data = dp_problem(torch, torch.float64)
    opt = amsgrad(PDDP_TRAINING["learning_rate"])
    (new, _, loss), wall = _timed(lambda: dp_train_step(
        loss_fn, params, opt, opt.init(params), data, dp))
    out["dp"] = {"wall_s": wall, "params": [p.cpu().numpy() for p in new],
                 "loss": float(loss), "rows_a_rank": DP_ROWS // size}
    return out


def shard_rank(rank, size, port, go, queue):
    """One rank of the gloo world on cuda:0: start, wait for ``go``, run
    ``shard_paths`` and put ``(rank, result)`` on ``queue`` (a traceback
    under "error" where it fails)."""
    import traceback

    import torch
    import torch.distributed as dist
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        torch.ones(1, device="cuda")
        go.wait()
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{}"
                                .format(port), world_size=size, rank=rank)
        try:
            queue.put((rank, shard_paths(size)))
        finally:
            dist.destroy_process_group()
    except Exception:
        queue.put((rank, {"error": traceback.format_exc()}))


def _collect(queue, procs, timeout):
    """Every rank's ``(rank, result)`` from ``queue``; fails where a rank
    ends without one or ``timeout`` seconds pass."""
    import queue as queue_mod
    out, end = {}, time.perf_counter() + timeout
    while len(out) < len(procs):
        try:
            rank, res = queue.get(timeout=5.0)
            out[rank] = res
        except queue_mod.Empty:
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            check(not dead and time.perf_counter() < end,
                  "a rank of the gloo world ended without a result "
                  "(exit codes {}) or the world timed out".format(dead))
    return out


def _world_report(world, ref, ref_p64, ref_dp):
    """A world's ranks against the unsharded runs: the batch (the first
    rank's gathered result; the others' equal to it), the float64
    particle solve, the data-parallel step; each rank's walls and
    launches."""
    import torch
    first = world[0]
    rep = {"ranks": first["ranks"], "backend": first["backend"],
           "walls_s": [{k: w[k]["wall_s"] for k in
                        ("batch", "psolve_float64", "psolve_float32", "dp")}
                       for w in world],
           "launches": [{k: w[k]["launches"] for k in
                         ("batch", "psolve_float64", "psolve_float32")}
                        for w in world]}
    b, rb = first["batch"]["result"], ref
    same = ((b["state"] == rb["state"]) & (b["iterations"]
            == rb["iterations"]) & (b["evals"] == rb["evals"]))
    rep["batch"] = {
        "lanes_a_rank": first["batch"]["lanes_a_rank"],
        "bit_equal": all(np.array_equal(b[f], rb[f]) for f in b),
        "other_ends": int((~same).sum()),
        "J_rel": float((np.abs(b["J_opt"] - rb["J_opt"])
                        / np.abs(rb["J_opt"])).max()),
        "U_err": float((np.abs(b["U"] - rb["U"]) - SHARD_BATCH_TOL["U_rtol"]
                        * np.abs(rb["U"])).max()),
        "ranks_equal": all(np.array_equal(w["batch"]["result"]["J_opt"],
                                          b["J_opt"]) for w in world)}
    p = first["psolve_float64"]["result"]
    rp = _host(ref_p64, ("Z", "U", "K", "J_opt", "state", "iterations",
                         "evals"))

    def excess(a, b, rtol, atol):
        """max |a - b| - (atol + rtol |b|): <= 0 within the tolerance."""
        return float((np.abs(a - b) - atol - rtol * np.abs(b)).max())
    rep["psolve_float64"] = {
        "ends": [_ilqr().iLQRState(p["state"]).name, p["iterations"],
                 p["evals"]],
        "ends_equal": all(p[f] == rp[f] for f in ENDS),
        "J_rel": abs(p["J_opt"] - rp["J_opt"]) / abs(rp["J_opt"]),
        "Z_excess": excess(p["Z"], rp["Z"], PSOLVE_TOL["ZU_rtol"],
                           PSOLVE_TOL["ZU_atol"]),
        "U_excess": excess(p["U"], rp["U"], PSOLVE_TOL["ZU_rtol"],
                           PSOLVE_TOL["ZU_atol"]),
        "K_excess": excess(p["K"], rp["K"], PSOLVE_TOL["K_rtol"],
                           PSOLVE_TOL["K_atol"]),
        "ranks_equal": all(w["psolve_float64"]["result"]["J_opt"]
                           == p["J_opt"] for w in world)}
    p32 = first["psolve_float32"]["result"]
    rep["psolve_float32"] = {"ends": [_ilqr().iLQRState(p32["state"]).name,
                                      p32["iterations"], p32["evals"]],
                             "J": p32["J_opt"],
                             "particles_a_rank":
                             first["psolve_float32"]["particles_a_rank"]}
    d = first["dp"]
    rep["dp"] = {"rows_a_rank": d["rows_a_rank"],
                 "params_err": max(float(np.abs(a - b).max())
                                   for a, b in zip(d["params"],
                                                   ref_dp["params"])),
                 "loss_rel": abs(d["loss"] - ref_dp["loss"])
                 / abs(ref_dp["loss"])}
    failed = []
    for w in world:
        lb = w["batch"]["launches"]
        if not (lb["K1"] >= 1 and lb["K1"] == lb["K2(a)"]
                == lb["evaluations"] and lb["K1_block"] == 0):
            failed.append("rank {}: the sharded batch did not launch K1 "
                          "and K2(a) once an evaluation: {}".format(
                              w["rank"], lb))
        for key in ("psolve_float64", "psolve_float32"):
            lp, ev = w[key]["launches"], w[key]["result"]["evals"]
            if not (lp["K1"] >= 1 and lp["K1"] == ev
                    and lp["K2(d)"] == 0):
                failed.append("rank {}: the particle-sharded solve's K1 "
                              "launches {} against {} evaluations".format(
                                  w["rank"], lp, ev))
    bt = rep["batch"]
    if not (bt["ranks_equal"] and bt["J_rel"] <= SHARD_BATCH_TOL["J_rtol"]
            and bt["U_err"] <= SHARD_BATCH_TOL["U_atol"]):
        failed.append("the sharded batch off the unsharded one: {}".format(
            bt))
    ps = rep["psolve_float64"]
    if not (ps["ends_equal"] and ps["ranks_equal"]
            and ps["J_rel"] <= PSOLVE_TOL["J_rtol"]
            and max(ps["Z_excess"], ps["U_excess"], ps["K_excess"]) <= 0):
        failed.append("the float64 particle-sharded solve off the "
                      "unsharded one: {}".format(ps))
    if not (rep["dp"]["params_err"] <= DP_TOL["params_atol"]
            and rep["dp"]["loss_rel"] <= DP_TOL["loss_rtol"]):
        failed.append("dp_train_step off one process's step: {}".format(
            rep["dp"]))
    return rep, failed


def phase18_multi_gpu(card):
    """Phase 18, multi-GPU on torch.distributed: ``shard_paths`` in a
    1-rank NCCL world in this process and in a 2-rank gloo world of
    spawned processes, both ranks on cuda:0 (started before the NCCL
    world, they wait for it to end: their start-up overlaps it, their
    work runs alone on the card). Each world against one unsharded
    ``batched_solve``, one unsharded float64 BNN solve and one step of
    AMSGrad on the whole batch in one process. Then K1 and K2(a) alone at
    a gloo rank's batch (its first 512 lanes, the local model of the
    first iterate, a reg per lane as in 16a) and K1 at the first local
    model of its particle-sharded float32 solve, each against its plain
    version, beside its bound. The 2-rank walls share one card and one
    host: they are no scaling number."""
    import multiprocessing

    import torch
    import torch.distributed as dist
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions, control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout, solve)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.parallel import batched_solve
    from pddp_tpu_torch.utils.optim import amsgrad, apply_updates
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    queue, go = ctx.Queue(), ctx.Event()
    port = _free_port()
    procs = [ctx.Process(target=shard_rank,
                         args=(r, SHARD_RANKS, port, go, queue), daemon=True)
             for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    try:
        ign = StateEncoding.IGNORE_UNCERTAINTY
        ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
        dist.init_process_group(
            "nccl", init_method="tcp://127.0.0.1:{}".format(_free_port()),
            world_size=1, rank=0, device_id=torch.device("cuda", 0))
        try:
            one = shard_paths(1)
        finally:
            dist.destroy_process_group()
        # The unsharded runs.
        model, cost, z0s, U0s = cartpole_batch(torch, torch.float32, "cuda",
                                               BATCHED_B, BATCHED_H)
        opts = ILQROptions(**BATCHED_OPTS, cost_in_scan=True,
                           riccati_mode="kernel", fused_rollout=True)
        ref = _host(batched_solve(model, cost, z0s, U0s, opts, encoding=ign))
        N = BNN_BATCH["N"]
        z0, U0 = bnn_start(torch, torch.float64, N)
        ref_p64 = solve(bnn_model(torch, torch.float64, N, True),
                        CartpoleCost(device="cuda", dtype=torch.float64), z0,
                        U0, ILQROptions(**PSOLVE_OPTS, riccati_mode="kernel"),
                        encoding=ch)
        _, loss_fn, params, data = dp_problem(torch, torch.float64)
        with torch.enable_grad():
            params = [p.requires_grad_(True) for p in params]
            loss = loss_fn(params, data)
            grads = torch.autograd.grad(loss, params)
        opt = amsgrad(PDDP_TRAINING["learning_rate"])
        ref_dp = {"params": [p.cpu().numpy() for p in apply_updates(
            params, opt.update(list(grads), opt.init(params), params)[0])],
            "loss": float(loss.detach())}
        go.set()
        gloo = _collect(queue, procs, 300.0)
    finally:
        go.set()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    errors = [w["error"] for w in gloo.values() if "error" in w]
    check(not errors, "the gloo world failed: {}".format(errors))
    res = {"phase": 18, "card": card}
    failed = []
    for label, world in (("nccl_1rank", [one]),
                         ("gloo_2ranks_one_card",
                          [gloo[r] for r in range(SHARD_RANKS)])):
        res[label], f = _world_report(world, ref, ref_p64, ref_dp)
        failed += ["{}: {}".format(label, x) for x in f]

    # The kernels alone at a gloo rank's shapes.
    rank0 = gloo[0]
    n = BATCHED_B // SHARD_RANKS
    Z0, AUX0 = rollout(model, z0s[:n], U0s[:n], ign)
    derivs = local_model(Z0, U0s[:n], AUX0, model, cost, ign)
    regs = torch.as_tensor(10.0**np.random.default_rng(16).uniform(
        1.0, 2.0, n), dtype=torch.float32, device="cuda")
    k1, (k, K, fin) = batched_k1_row(
        derivs, regs, "cartpole_sharded_b{}".format(n),
        rank0["batch"]["launches"]["K1"])
    alphas = default_fit_alphas(torch.float32, "cuda")
    A, H = alphas.shape[0], BATCHED_H
    Z_k, U_k, J_k = (t[fin] for t in fr.fused_control_law(
        model, derivs[0], U0s[:n], k, K, alphas, ign, cost=cost))
    Z_p, U_p, J_p = (t[fin] for t in control_law(
        model, derivs[0], U0s[:n], k, K, alphas, ign, cost=cost,
        cost_in_scan=True))
    bound, by, roof, chain = chain_bound_ms(
        *k2_work(n, H, A, 4, False), "float32",
        k2_chain_cycles("cartpole", 4, 4, "float32"), H)
    errs = [rel_err(a, b) for a, b in ((Z_k, Z_p), (U_k, U_p), (J_k, J_p))]
    k2 = {"kernel": "K2(a)", "path": "cartpole_sharded_b{}".format(n),
          "B": n, "N": H, "A": A,
          "ms": events_ms(raw_k2(model, cost, derivs[0], U0s[:n], k, K,
                                 alphas), 20),
          "plain_ms": events_ms(lambda: control_law(
              model, derivs[0], U0s[:n], k, K, alphas, ign, cost=cost,
              cost_in_scan=True), 1, warmup=0),
          "bound_ms": bound, "bound_by": by, "roofline_ms": roof,
          "chain_floor_ms": chain,
          "launches": rank0["batch"]["launches"]["K2(a)"],
          "max_abs_err": max(e[0] for e in errs),
          "rel_err": max(e[1] for e in errs)}
    bnn = [torch.as_tensor(a, device="cuda")[None] for a in
           rank0["psolve_float32"]["first_local_model"]]
    k1_bnn, _ = batched_k1_row(
        bnn, torch.ones(1, device="cuda"), "bnn_particle_sharded_p{}".format(
            rank0["psolve_float32"]["particles_a_rank"]),
        rank0["psolve_float32"]["launches"]["K1"])
    res["kernel_rows"] = [k1, k2, k1_bnn]
    if not (k1["ok_equal"] and k1["rel_err"] <= TOL[("K1", "float32")]
            and k2["rel_err"] <= TOL[("K2", "float32")]
            and k1_bnn["ok_equal"]
            and k1_bnn["rel_err"] <= TOL[("K1", "float32")]):
        failed.append("K1 or K2(a) off its plain version at a rank's "
                      "shape: {} {} {}".format(k1, k2, k1_bnn))
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    check(not failed, "; ".join(failed))
    return res


# ---------------------------------------------------------------------------
# Phase 19: the rest of K2's gate: K2(e), K2(d) under four more codecs and
# K2(a)-(c) on constrain_model's examples
# ---------------------------------------------------------------------------

# K2(e), K2(d) and the constrained K2(a)-(c) in float64 against their
# plain versions, max|kernel - plain| / max|plain| of each output:
# pddp_tpu's own tolerances for its kernel against the scan
# (tests/ops/test_fused_rollout.py:155-158), Z, U and AUX 1e-10, J 1e-8.
REST_TOL = {"Z": 1e-10, "U": 1e-10, "AUX": 1e-10, "J": 1e-8}
# float32, phase 1's rule for K1's block kernel (f32_derived): each output
# of the kernel against the float64 plain version on the same inputs (the
# float32 model and inputs cast up) within the larger of REST_F32_FLOOR and
# twice the float32 plain version's own distance there.
REST_F32_FLOOR = 1e-5
# 19b: phase 8's trained BNN under the codecs beside its Cholesky one.
BNN_REST_CODECS = ("VARIANCE_ONLY", "STANDARD_DEVIATION_ONLY",
                   "FULL_COVARIANCE_MATRIX", "IGNORE_UNCERTAINTY")
# 19c: constrain_model(-PDDP_UMAX, PDDP_UMAX) of these examples (label,
# example, codec, K2's stage), solved from U0 = 0.1 at H=200 as phase 12's
# paths are, through K1 and K2; float64 against the CPU's plain solve.
CONSTRAINED_PATHS = (
    ("constrained_cartpole", "cartpole", "IGNORE_UNCERTAINTY", "a"),
    ("constrained_double_cartpole", "double_cartpole", "IGNORE_UNCERTAINTY",
     "b"),
    ("constrained_pendulum_chol", "pendulum", "UPPER_TRIANGULAR_CHOLESKY",
     "c"))
CONSTRAINED_H = 200
CONSTRAINED_OPTS = {"n_iterations": 10}
CONSTRAINED_J_RTOL = 1e-10
# The constrained double cartpole's float64 solve at H=200 is not a
# function of its inputs to rounding: on the CPU through the plain
# versions a change of 1e-15 in its start moves J by 9e-10 after one
# iteration, and its end from ACCEPTED after 10 iterations to MAX_REG
# after 5 (scripts/torch_constrained_branch.py; ROADMAP C). Its ends at
# H=200 are reported, and a second run of that solve on the card is held
# to the first's bits; its ends are held against the CPU's at these
# settings instead, phase 11's golden horizon, where the same changes of
# the start move J by 1.6e-15 at most.
CONSTRAINED_SHORT = {"constrained_double_cartpole": {"H": 25,
                                                     "n_iterations": 25}}
# Operations of one mean step of each example (as MODEL_OPS) on the
# latency chain from its state and action to the next state, in LATENCY's
# units: the sines and cosines, dependent FMAs and divisions.
MODEL_CHAIN = {"cartpole": ("sincos", 6, 1), "pendulum": ("sincos", 4, 1),
               "double_cartpole": ("sincos", 12, 1),
               "rendezvous": (None, 4, 1)}


def cast_tree(obj, dtype):
    """A copy of a port model or cost with every floating tensor cast to
    ``dtype``: the float32 model's own values, for a float64 reference on
    the same inputs."""
    import copy
    import enum

    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, list):
        return [cast_tree(o, dtype) for o in obj]
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(cast_tree(o, dtype) for o in obj)
    if isinstance(obj, dict):
        return {k: cast_tree(v, dtype) for k, v in obj.items()}
    if (isinstance(obj, (enum.Enum, type)) or not hasattr(obj, "__dict__")
            or not type(obj).__module__.startswith("pddp_tpu_torch")):
        return obj
    new = copy.copy(obj)
    for k, v in vars(obj).items():
        setattr(new, k, cast_tree(v, dtype))
    return new


def k2e_work(name, codec, B, N, A, P, itemsize, bounded=False, inner=None):
    """(bytes, operations) of one K2(e) call over example ``name`` under
    codec ``codec`` (StateEncoding's value), or over the traced inner step
    ``inner`` (a ``_trace.TracedInner``: its sizes, its leaves and its
    program's operations in place of the example's; name None): each
    input read once (the
    noise table's N steps), each output written once (AUX the most); per
    candidate and step the feedback law, per particle the noise solve
    (n(n-1)/2 multiply-adds and n divisions), X = mean + eps Uc, the
    model's step and the moment match's sums, then the divisions by P and
    one Cholesky factorization under the matrix codecs (CHOL's encode,
    FULL's decode; the ladder's first rung, where these inputs factor) or
    n square roots under VAR and STD."""
    if inner is None:
        n, nu, _ = SIZES[name]
        n_params, model_ops = 8, MODEL_OPS[name]
    else:
        n, nu = inner.n, inner.nu
        n_params = inner.n_static + inner.n_dynamic
        model_ops = inner.step.op_count()
    nz = {0: n + n * n, 1: n + n * (n + 1) // 2, 2: 2 * n, 3: 2 * n,
          4: n}[codec]
    matrix = codec in (0, 1)
    n_in = (B * ((N + 1) * nz + 2 * N * nu + N * nu * nz) + A + n_params
            + 2 * nu + N * P * n + (2 * nu if bounded else 0))
    n_out = B * ((N + 1) * A * nz + N * A * nu + N * A * P * n)
    second = (0 if codec == 4 else
              n + 2 * (n * (n + 1) // 2) if matrix else 3 * n)
    particle = (n * (n - 1) + n) + (2 * n * n + n) + model_ops + n
    belief = ((2 * n**3 // 3 + n + n * (n - 1) // 2) if matrix
              else n if codec in (2, 3) else 0)
    step = (2 * nz + 3 + (2 if bounded else 0) + P * (particle + second)
            + 2 * n + belief)
    return (n_in + n_out) * itemsize, B * A * N * step


def k2e_chain_cycles(name, codec, nz, P, dtype_name, constrained=False,
                     inner=None):
    """Cycles of one K2(e) step's critical path, counted by hand from
    csrc/fused_particle_rollout.cuh at LATENCY's latencies: the feedback
    law z -> u (nz FMAs, two adds; constrain_model's tanh and two FMAs),
    beside it the noise solve (n chained subtract-and-divides) and X (n
    FMAs); the example's step (MODEL_CHAIN), or the traced inner step's
    longest chain (``inner``, a ``_trace.TracedInner``: ``Program.chain``
    at these latencies; name None); the sums over P of the mean
    and then the second moments, as trees (the least depth of any order),
    each with its division; under the matrix codecs one n x n Cholesky (n
    square roots and divisions behind 2n FMAs), under VAR and STD a square
    root. Block barriers are the design's, not the function's: left
    out."""
    lat = LATENCY[dtype_name]
    fma, div = lat["fma"], lat["div"]
    n = SIZES[name][0] if inner is None else inner.n
    u = (nz + 3) * fma + ((lat["sincos"] + 2 * fma) if constrained else 0)
    noise = n * (fma + div) + n * fma
    if inner is None:
        sc, fmas, divs = MODEL_CHAIN[name]
        model = (lat[sc] if sc else 0) + fmas * fma + divs * div
    else:
        model = inner.chain(lat)[0]
    depth = int(np.ceil(np.log2(P)))
    moments = (depth + 1) * fma + div
    if codec != 4:
        moments += (depth + 2) * fma + div
    belief = (n * (lat["sqrt"] + div) + 2 * n * fma if codec in (0, 1)
              else lat["sqrt"] if codec in (2, 3) else 0)
    return max(u, noise) + model + moments + belief


def raw_k2e(model, Z, U, k, K, alphas, enc):
    """A closure launching K2(e) alone on preallocated outputs."""
    import torch
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    from pddp_tpu_torch.ops._examples import (MODELS, example_of,
                                              param_buffer)
    if Z.dim() == 2:
        Z, U, k, K = (t[None] for t in (Z, U, k, K))
    B, N, A = U.shape[0], U.shape[1], alphas.shape[0]
    nz, nu, n, P = Z.shape[-1], U.shape[-1], model.state_size, \
        model.n_particles
    dtype = Z.dtype
    base, constrained = example_of(model.inner)
    params = param_buffer(model.inner, None, dtype, "cuda")
    eps = model.eps.to(dtype).contiguous()
    outs = [torch.empty(s, dtype=dtype, device="cuda")
            for s in ((B, N + 1, A, nz), (B, N, A, nu), (B, N, A, P, n))]
    fn = fpr._function(dtype)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = ([t.data_ptr() for t in (Z, U, k, K, alphas, params, eps)]
            + [None] + [o.data_ptr() for o in outs]
            + [B, N, A, P, MODELS[base], int(enc), int(constrained),
               int(bool(model.infer_noise_variables)), stream])

    def launch():
        check(fn(*ptrs) == 0, "K2(e) launch")
    return launch


def batch_of(rng, Z, U, k, K, B):
    """B solves of one: Z and U repeated, the gains perturbed by 1 %."""
    import torch

    def noise(t):
        return (t * torch.as_tensor(
            1.0 + 0.01 * rng.standard_normal((B,) + tuple(t.shape)),
            dtype=t.dtype, device=t.device)).contiguous()
    return (Z.expand((B,) + Z.shape).contiguous(),
            U.expand((B,) + U.shape).contiguous(), noise(k), noise(K))


def rest_errors(kern, plain):
    """{output: (max abs, max abs / max |plain|)} of Z, U, J and AUX (the
    examples' AUX is ())."""
    return {key: rel_err(a, p) for key, a, p in zip(
        ("Z", "U", "J", "AUX"), kern, plain) if not isinstance(a, tuple)}


def rest_f32(kern, plain, ref):
    """The float32 check (REST_F32_FLOOR): each output's distance to the
    float64 plain version ``ref`` on the same inputs, the float32 plain
    version's own, the tolerance derived from it, and the kernel's
    distance to the float32 plain version (reported)."""
    import torch
    out = {}
    for key, a, p, r in zip(("Z", "U", "J", "AUX"), kern, plain, ref):
        if isinstance(a, tuple):
            continue
        rel_k = rel_err(a.double(), r)[1]
        rel_p = rel_err(p.double(), r)[1]
        rel_kp = rel_err(a, p)[1]
        out[key] = {"kernel_vs_f64": rel_k, "plain_f32_vs_f64": rel_p,
                    "kernel_vs_plain_f32": rel_kp,
                    **f32_derived(rel_k, rel_p, rel_kp, REST_F32_FLOOR),
                    "finite": bool(torch.isfinite(a).all())}
        out[key]["held"] = out[key]["held"] and out[key]["finite"]
    return out


def rest_f64_held(errs):
    return all(errs[key][1] <= REST_TOL[key] for key in errs)


def line_search_with_argmin(model, cost, Z, U, k, K, alphas, enc):
    """fused_control_law with the cost as a post-pass (the stateful
    stages') and the finite argmin of J, as an iteration takes it."""
    import torch
    from pddp_tpu_torch.ops import fused_rollout as fr
    out = fr.fused_control_law(model, Z, U, k, K, alphas, enc, cost=cost,
                               with_aux=True)
    J = out[2]
    best = int(torch.argmin(torch.where(torch.isfinite(J), J, torch.inf)))
    return out, best


def k1_first_finite(derivs, regs):
    """K1's gains at the first reg of ``regs`` at which they are finite,
    or (None, None, None)."""
    from pddp_tpu_torch.ops import backward_kernel as bk
    for reg in regs:
        k, K, ok = bk.kernel_backward(*derivs, reg=reg)
        if bool(ok):
            return k, K, reg
    return None, None, None


def timed_call(fn):
    """(fn's result, its device time in ms by CUDA events), one call."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def reset_all_counts():
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.ops import traced_rollout as tro
    bk.launches = bk.block_launches = 0
    for counts in (fr.launches, fb.launches, fpr.launches, tro.launches):
        reset_counts(counts)


def read_counts():
    from pddp_tpu_torch.ops import backward_kernel as bk
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.ops import traced_rollout as tro
    return {"K1": bk.launches + bk.block_launches,
            **{"K2(" + k + ")": v for k, v in fr.launches.items()},
            "K2(d)": fb.launches["rollout"],
            "K2(e)": fpr.launches["rollout"],
            "K2(e) traced": fpr.launches["traced"],
            "K2(f)": tro.launches["rollout"],
            "K2(g)": tro.launches["stateful"]}


def rest_row_times(raw1, raw64, work1, work64, cycles, N, dtype_name):
    """The kernel alone at B=1 and B=64 (CUDA events) beside its bound."""
    b1, by1, roof1, chain1 = chain_bound_ms(*work1, dtype_name, cycles, N)
    b64, by64, roof64, chain64 = chain_bound_ms(*work64, dtype_name, cycles,
                                                N)
    return {"ms": events_ms(raw1, 20), "ms_B64": events_ms(raw64, 5),
            "bound_ms": b1, "bound_by": by1, "roofline_ms": roof1,
            "chain_floor_ms": chain1, "bound_ms_B64": b64,
            "bound_by_B64": by64}


def phase19a_particles(card, local_models):
    """19a: one iteration of each phase-17 row (PARTICLE_ROWS, P=100,
    N=50) through K1 and K2(e): the local model of U0 (phase 17's), K1 at
    the first reg of PARTICLE_K1_REGS that gives finite gains (each type
    its own; a row whose gains are finite at no reg fails), and
    ``fused_control_law`` with the cost as a post-pass and
    the argmin; in float64 and float32, each against the plain
    ``control_law`` (REST_TOL; float32 rest_f32), and K2(e) alone at B=1
    and B=64."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout)
    from pddp_tpu_torch.encoding import StateEncoding
    f32, f64 = torch.float32, torch.float64
    rows, failed = [], []
    rng = np.random.default_rng(19)
    for label, ex, codec, constrained in PARTICLE_ROWS:
        enc = StateEncoding[codec]
        m64, c64, z064, U064 = particle_problem(label, "cuda", f64)
        d64 = local_models[label].get("float64")
        if d64 is None:   # 17b's row ran in float32 alone
            Z, AUX = rollout(m64, z064, U064, enc)
            d64 = local_model(Z, U064, AUX, m64, c64, enc)
        m32, c32, _, U0 = particle_problem(label, "cuda", f32)
        d32 = local_models[label]["float32"]
        row = {"path": label, "example": ex, "codec": codec,
               "constrained": constrained, "P": m32.n_particles,
               "N": U0.shape[0], "nz": d32[0].shape[-1]}
        # float64: the iteration, held against the plain version.
        reset_all_counts()
        k64, K64, reg64 = k1_first_finite(d64, PARTICLE_K1_REGS)
        if k64 is None:
            failed.append("{}: K1's float64 gains finite at no reg".format(
                label))
            continue
        a64 = default_fit_alphas(f64, "cuda")
        out64, best64 = line_search_with_argmin(m64, c64, d64[0], U064, k64,
                                                K64, a64, enc)
        torch.cuda.synchronize()
        row["float64"] = {"reg": reg64, "launches": read_counts(),
                          "best": best64}
        plain64 = control_law(m64, d64[0], U064, k64, K64, a64, enc,
                              cost=c64, with_aux=True)
        errs = rest_errors(out64, plain64)
        row["float64"]["errors"] = errs
        row["float64"]["held"] = rest_f64_held(errs)
        row["max_abs_err"] = max(e[0] for e in errs.values())
        # float32: the iteration, held by the derived tolerance.
        reset_all_counts()
        k32, K32, reg32 = k1_first_finite(d32, PARTICLE_K1_REGS)
        if k32 is None:
            failed.append("{}: K1's float32 gains finite at no reg".format(
                label))
            continue
        a32 = default_fit_alphas(f32, "cuda")
        out32, best32 = line_search_with_argmin(m32, c32, d32[0], U0, k32,
                                                K32, a32, enc)
        torch.cuda.synchronize()
        counts = read_counts()
        plain32, plain_ms = timed_call(lambda: control_law(
            m32, d32[0], U0, k32, K32, a32, enc, cost=c32, with_aux=True))
        ref = control_law(cast_tree(m32, f64), d32[0].double(), U0.double(),
                          k32.double(), K32.double(), a32.double(), enc,
                          cost=cast_tree(c32, f64), with_aux=True)
        hold = rest_f32(out32, plain32, ref)
        row["float32"] = {"reg": reg32, "launches": counts,
                          "best": best32, "best_plain": int(torch.argmin(
                              torch.where(torch.isfinite(plain32[2]),
                                          plain32[2], torch.inf))),
                          "check": hold}
        row["launches"] = counts["K2(e)"]
        row["plain_ms"] = plain_ms
        # K2(e) alone, float32.
        raw1 = raw_k2e(m32, d32[0], U0, k32, K32, a32, enc)
        raw64 = raw_k2e(m32, *batch_of(rng, d32[0], U0, k32, K32, 64), a32,
                        enc)
        cyc = k2e_chain_cycles(ex, int(enc), row["nz"], m32.n_particles,
                               "float32", constrained)
        row.update(rest_row_times(
            raw1, raw64,
            k2e_work(ex, int(enc), 1, row["N"], 10, m32.n_particles, 4),
            k2e_work(ex, int(enc), 64, row["N"], 10, m32.n_particles, 4),
            cyc, row["N"], "float32"))
        row["chain_cycles"] = cyc
        if not row["float64"]["held"]:
            failed.append("{}: K2(e) float64 off its plain version: "
                          "{}".format(label, errs))
        if not all(v["held"] for v in hold.values()):
            failed.append("{}: K2(e) float32 past its derived tolerance: "
                          "{}".format(label, hold))
        for dname in ("float64", "float32"):
            c = row[dname]["launches"]
            if c["K2(e)"] != 1 or c["K1"] < 1:
                failed.append("{}: {} iteration launched {}".format(
                    label, dname, c))
        emit({"phase": "19a", "card": card, **row})
        rows.append(row)
    return rows, failed


def phase19b_bnn(card):
    """19b: phase 8's trained BNN (6-200-200-8, P=100, N=25, from
    bnn_start's state under each codec) under BNN_REST_CODECS: one
    iteration through K1 (reg 1, raised tenfold until finite) and K2(d) in
    float64 and float32, held and timed as in 19a."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout)
    from pddp_tpu_torch.encoding import StateEncoding, encode
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    f32, f64 = torch.float32, torch.float64
    N = 25
    rows, failed = [], []
    rng = np.random.default_rng(20)
    models = {dt: bnn_model(torch, dt, N, True) for dt in (f32, f64)}
    costs = {dt: CartpoleCost(device="cuda", dtype=dt) for dt in (f32, f64)}
    for codec in BNN_REST_CODECS:
        enc = StateEncoding[codec]
        row = {"path": "bnn_" + codec.lower(), "codec": codec, "N": N,
               "P": 100}
        outs = {}
        for dt in (f64, f32):
            dname = str(dt).replace("torch.", "")
            model, cost = models[dt], costs[dt]
            z0 = encode(torch.zeros(4, dtype=dt, device="cuda"),
                        V=1e-2 * torch.ones(4, dtype=dt, device="cuda"),
                        encoding=enc)
            U = torch.full((N, 1), 0.1, dtype=dt, device="cuda")
            Z, AUX = rollout(model, z0, U, enc)
            derivs = local_model(Z, U, AUX, model, cost, enc)
            reset_all_counts()
            k, K, reg = k1_first_finite(derivs, (1.0, 10.0, 100.0, 1e3))
            if k is None:
                failed.append("{}: K1's {} gains finite at no reg".format(
                    row["path"], dname))
                break
            alphas = default_fit_alphas(dt, "cuda")
            out, best = line_search_with_argmin(model, cost, derivs[0], U,
                                                k, K, alphas, enc)
            torch.cuda.synchronize()
            counts = read_counts()
            plain, plain_ms = timed_call(lambda: control_law(
                model, derivs[0], U, k, K, alphas, enc, cost=cost,
                with_aux=True))
            row[dname] = {"reg": reg, "launches": counts, "best": best}
            outs[dt] = (model, cost, derivs[0], U, k, K, alphas)
            if dt == f64:
                errs = rest_errors(out, plain)
                row[dname].update(errors=errs, held=rest_f64_held(errs))
                row["max_abs_err"] = max(e[0] for e in errs.values())
                if not row[dname]["held"]:
                    failed.append("{}: K2(d) float64 off its plain "
                                  "version: {}".format(row["path"], errs))
            else:
                ref = control_law(cast_tree(model, f64),
                                  *(t.double() for t in (derivs[0], U, k, K,
                                                         alphas)),
                                  enc, cost=cast_tree(cost, f64),
                                  with_aux=True)
                hold = rest_f32(out, plain, ref)
                row[dname]["check"] = hold
                row["plain_ms"] = plain_ms
                row["launches"] = counts["K2(d)"]
                if not all(v["held"] for v in hold.values()):
                    failed.append("{}: K2(d) float32 past its derived "
                                  "tolerance: {}".format(row["path"], hold))
            if counts["K2(d)"] != 1 or counts["K1"] < 1:
                failed.append("{}: {} iteration launched {}".format(
                    row["path"], dname, counts))
        if f32 not in outs:
            continue
        model, cost, Zn, U, k, K, alphas = outs[f32]
        nz = Zn.shape[-1]
        raw1 = raw_bnn(torch, "rollout", model, f32, (Zn[None], U[None],
                                                      k[None], K[None],
                                                      alphas), enc)
        raw64 = raw_bnn(torch, "rollout", model, f32,
                        batch_of(rng, Zn, U, k, K, 64) + (alphas,), enc)
        cyc = k2d_chain_cycles(4, nz, [6, 200, 200, 8], 100, "float32",
                               int(enc))
        row.update(rest_row_times(
            raw1, raw64, bnn_work(model, 1, N, 10, 10, 4,
                                  int(enc))["K2(d)"],
            bnn_work(model, 64, N, 10, 10, 4, int(enc))["K2(d)"], cyc, N,
            "float32"))
        row["chain_cycles"] = cyc
        row["plan"] = fb.launch_plan(model, 10, f32, enc)
        emit({"phase": "19b", "card": card, **row})
        rows.append(row)
    return rows, failed


def constrained_problem(ex, codec, device, dtype, H=CONSTRAINED_H):
    """(model, cost, z0, U0) of a CONSTRAINED_PATHS row: the example's
    model squashed into [-PDDP_UMAX, PDDP_UMAX] by constrain_model, its
    cost, EXAMPLES' start under the codec, U0 = 0.1 over H steps."""
    import importlib

    import torch
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.utils.constraint import constrain_model
    mod, model_cls, cost_cls, x0, dt, _ = EXAMPLES[ex]
    m = importlib.import_module("pddp_tpu_torch.examples." + mod)
    cls = constrain_model(-PDDP_UMAX, PDDP_UMAX)(getattr(m, model_cls))
    model = cls(dt=dt, device=device, dtype=dtype)
    z0 = start_state(torch.tensor(x0, dtype=dtype, device=device),
                     StateEncoding[codec])
    U0 = torch.full((H, model.action_size), 0.1, dtype=dtype,
                    device=device)
    return model, getattr(m, cost_cls)(device=device, dtype=dtype), z0, U0


def constrained_settings(label):
    """(H, solve options) at which 19c holds a row's float64 ends."""
    short = CONSTRAINED_SHORT.get(label)
    if short is None:
        return CONSTRAINED_H, CONSTRAINED_OPTS
    return short["H"], {"n_iterations": short["n_iterations"]}


def constrained_cpu_solves():
    """19c's float64 solves on the CPU through the plain versions (for
    ``cpu_references``) at each row's ``constrained_settings``, the cost
    summed in the scan under IGNORE_UNCERTAINTY as K2(a)-(b) sum it."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.encoding import StateEncoding
    out = {}
    for label, ex, codec, _ in CONSTRAINED_PATHS:
        H, opts = constrained_settings(label)
        model, cost, z0, U0 = constrained_problem(ex, codec, "cpu",
                                                  torch.float64, H)
        enc = StateEncoding[codec]
        out[label] = solve(model, cost, z0, U0, ILQROptions(
            **opts, cost_in_scan=enc == StateEncoding.IGNORE_UNCERTAINTY),
            encoding=enc)
    return out


def phase19c_constrained(card, cpu):
    """19c: ``solve(..., fused_rollout=True, riccati_mode="kernel")`` at
    H=200 on each CONSTRAINED_PATHS row in float64 and float32 (its
    wall), K1 and K2 launched once an evaluation; the float64 ends held
    against the CPU's plain solve (``cpu``: the same ends and J within
    CONSTRAINED_J_RTOL) at ``constrained_settings``, so for the rows of
    CONSTRAINED_SHORT in a solve of their own, whose H=200 solve is run
    twice and held to the same bits; then K2
    alone at the local model of the float32 solve's result (the reg
    doubled from its mu until the gains and the plain candidates are
    finite, as phase 12), against its plain version in float64 (REST_TOL)
    and float32 (rest_f32), at B=1 and B=64."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions, backward,
                                                 control_law,
                                                 default_fit_alphas,
                                                 local_model, solve)
    from pddp_tpu_torch.encoding import StateEncoding
    f32, f64 = torch.float32, torch.float64
    rows, failed = [], []
    rng = np.random.default_rng(21)
    opts = ILQROptions(**CONSTRAINED_OPTS, riccati_mode="kernel",
                       fused_rollout=True)
    for label, ex, codec, st in CONSTRAINED_PATHS:
        enc = StateEncoding[codec]
        ign = enc == StateEncoding.IGNORE_UNCERTAINTY
        row = {"path": label, "example": ex, "codec": codec, "stage": st,
               "H": CONSTRAINED_H}
        for dt in (f64, f32):
            dname = str(dt).replace("torch.", "")
            model, cost, z0, U0 = constrained_problem(ex, codec, "cuda", dt)
            reset_all_counts()
            t0 = time.perf_counter()
            r = solve(model, cost, z0, U0, opts, encoding=enc)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            counts = read_counts()
            row[dname] = {**_ends(r), "wall_ms": wall, "launches": counts}
            if not (counts["K1"] == r.evals and counts["K2(" + st + ")"]
                    == r.evals == sum(counts[s] for s in
                                      ("K2(a)", "K2(b)", "K2(c)"))):
                failed.append("{}: {} solve's launches {} differ from its "
                              "{} evaluations".format(label, dname, counts,
                                                      r.evals))
            if dt == f64 and label in CONSTRAINED_SHORT:
                again = solve(model, cost, z0, U0, opts, encoding=enc)
                row[dname]["repeat_same_bits"] = all(
                    bool(torch.equal(a, b)) for a, b in
                    ((r.Z, again.Z), (r.U, again.U))) and (
                        _ends(r) == _ends(again))
                if not row[dname]["repeat_same_bits"]:
                    failed.append("{}: a second float64 solve on the card "
                                  "differs from the first: {} {}".format(
                                      label, _ends(r), _ends(again)))
                H, short = constrained_settings(label)
                r = solve(*constrained_problem(ex, codec, "cuda", dt, H),
                          ILQROptions(**short, riccati_mode="kernel",
                                      fused_rollout=True), encoding=enc)
                held = row["float64_H{}".format(H)] = _ends(r)
            else:
                held = row[dname]
            if dt == f64:
                c = cpu[label]
                held["cpu"] = _ends(c)
                held["J_rel"] = abs(r.J_opt - c.J_opt) / abs(c.J_opt)
                if not (
                        (r.state, r.iterations, r.evals)
                        == (c.state, c.iterations, c.evals)
                        and held["J_rel"] <= CONSTRAINED_J_RTOL):
                    failed.append("{}: the float64 solve through the "
                                  "kernels differs from the CPU's: "
                                  "{}".format(label, held))
            if dt == f32:
                r32, model32, cost32 = r, model, cost
        row["launches"] = row["float32"]["launches"]["K2(" + st + ")"]
        # K2 alone at the float32 solve's result.
        derivs = local_model(r32.Z, r32.U, (), model32, cost32, enc)
        Zn, Un = derivs[0], r32.U
        a32 = default_fit_alphas(f32, "cuda")

        def plain_ls(m, c, Z, U, k, K, a):
            return control_law(m, Z, U, k, K, a, enc, cost=c,
                               cost_in_scan=ign)
        reg = max(r32.mu, 1e-6)
        for _ in range(64):
            k, K, ok = backward(*derivs, reg=reg)
            if bool(ok) and all(bool(torch.isfinite(x).all()) for x in
                                plain_ls(model32, cost32, Zn, Un, k, K, a32)):
                break
            reg *= 2.0
        row["reg"] = reg
        kern32 = fr_call(model32, cost32, Zn, Un, k, K, a32, enc)
        plain32, plain_ms = timed_call(
            lambda: plain_ls(model32, cost32, Zn, Un, k, K, a32))
        m64, c64 = cast_tree(model32, f64), cast_tree(cost32, f64)
        ins64 = tuple(t.double() for t in (Zn, Un, k, K))
        a64 = a32.double()
        ref = plain_ls(m64, c64, *ins64, a64)
        kern64 = fr_call(m64, c64, *ins64, a64, enc)
        errs = rest_errors(kern64, ref)
        row["float64"]["kernel"] = {"errors": errs,
                                    "held": rest_f64_held(errs)}
        row["max_abs_err"] = max(e[0] for e in errs.values())
        hold = rest_f32(kern32, plain32, ref)
        row["float32"]["kernel"] = hold
        row["plain_ms"] = plain_ms
        if not row["float64"]["kernel"]["held"]:
            failed.append("{}: K2({}) float64 off its plain version: "
                          "{}".format(label, st, errs))
        if not all(v["held"] for v in hold.values()):
            failed.append("{}: K2({}) float32 past its derived tolerance: "
                          "{}".format(label, st, hold))
        kc = cost32 if ign else None
        raw1 = raw_k2(model32, kc, Zn, Un, k, K, a32, enc)
        raw64 = raw_k2(model32, kc, *batch_of(rng, Zn, Un, k, K, 64), a32,
                       enc)
        nz = Zn.shape[-1]
        cyc = k2_chain_cycles(ex, int(enc), nz, "float32") + (
            LATENCY["float32"]["sincos"] + 2 * LATENCY["float32"]["fma"])
        row.update(rest_row_times(
            raw1, raw64,
            k2_work(1, CONSTRAINED_H, 10, 4, False, ex, int(enc)),
            k2_work(64, CONSTRAINED_H, 10, 4, False, ex, int(enc)),
            cyc, CONSTRAINED_H, "float32"))
        row["chain_cycles"] = cyc
        emit({"phase": "19c", "card": card, **row})
        rows.append(row)
    return rows, failed


def fr_call(model, cost, Z, U, k, K, alphas, enc):
    """K2(a)-(c) as a solve's line search calls it: the cost in the kernel
    under IGNORE_UNCERTAINTY, a post-pass otherwise."""
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    ign = enc == StateEncoding.IGNORE_UNCERTAINTY
    return fr.fused_control_law(model, Z, U, k, K, alphas, enc,
                                cost=cost if ign else None)


def phase19_rest_of_k2(card, particles, cpu):
    """Phase 19, the rest of K2's gate on the card: 19a K2(e) on phase
    17's rows, 19b K2(d) under four more codecs, 19c constrain_model's
    examples through K2(a)-(c). The particle solves of phase 17 launched
    no K2 (pddp_tpu's gate keeps the stateful model on the scan), which is
    checked here too."""
    t0 = time.perf_counter()
    a, fa = phase19a_particles(card, particles["local_models"])
    b, fb_ = phase19b_bnn(card)
    c, fc = phase19c_constrained(card, cpu)
    failed = fa + fb_ + fc
    for row in particles["rows"]:
        if row["launches"]["K2"] != 0:
            failed.append("{}: the particle solve launched K2: {}".format(
                row["path"], row["launches"]))
    res = {"phase": 19, "particles": a, "bnn": b, "constrained": c,
           "seconds": time.perf_counter() - t0}
    emit({"phase": 19, "seconds": res["seconds"]})
    check(not failed, "; ".join(failed))
    return res


# ---------------------------------------------------------------------------
# Phase 20: K2(d) and F3 under the BNN's bfloat16 knobs
# ---------------------------------------------------------------------------

BF16_KNOBS = ("compute_dtype", "matmul_dtype")
BF16_CODECS = ("UPPER_TRIANGULAR_CHOLESKY", "VARIANCE_ONLY",
               "STANDARD_DEVIATION_ONLY", "FULL_COVARIANCE_MATRIX",
               "IGNORE_UNCERTAINTY")
# float64: kernel and plain version round the same operands at the same
# points and sum the exact bfloat16 products in float64 in another order;
# a rounding to bfloat16 lands elsewhere only where that order moves a sum
# across a rounding boundary (about 2^-45 of the sums at K = 200).
BF16_F64_TOL = 1e-10
# float32 (``bf16_derived``): the kernel against the float64 plain
# version of the same knob on the same inputs within the larger of this
# floor (float32's order of sums over a 25-step chain, as REST_F32_FLOOR)
# and twice the float32 plain version's own distance there.
BF16_F32_FLOOR = 1e-5
# Dense bfloat16 tensor-core peak of one H100 SXM at 700 W (NVIDIA's data
# sheet; mma.sync reaches part of it, wgmma all of it).
PEAK_BF16_FLOPS = 989e12
# Cycles of one m16n8k16 mma.sync's result on the chain (the H100's
# HMMA latency, about 32 cycles; an assumption of the chain floor).
MMA_LATENCY = 32
# 20d: each examples_torch script on the card, its depth cut: iLQR
# iterations, training steps, MPC ticks and frames (its widths, particles,
# batch and horizons are the script's), so that phase 20 stays near 90 s.
# The experiment and its three problem scripts run one MPC trial
# (max_trials 1 of 5) cut to its first tick; phase 15b runs the
# experiment's cartpole trial deeper. parallel_solves runs its B=256,
# H=100 batch at 1 iteration of 10 (max_evals 3 of 30): at 2 it took
# 29.0 s of phase 20's 117 on an NVIDIA H100 80GB HBM3 at 700 W, on a
# host that ran known_dynamics 1.3x slower than the one before (PERF.md).
SCRIPT_CUTS = {
    "known_dynamics": {"n_iterations": 1},
    "experiment": {"max_trials": 1, "n_iterations": 1, "train_n_iter": 20,
                   "mpc_ticks": 1},
    "parallel_solves": {"n_iterations": 1, "max_evals": 3},
    "animation": {"iterations": 3},
    "mpc_animation": {"iterations": 3}}
# The scripts that set fused_rollout on the card: 20d fails unless their
# line searches launched K2.
SCRIPT_FUSED = ("known_dynamics", "animation", "mpc_animation")
# Scripts whose outputs are not finite, as pddp_tpu's are not: the double
# cartpole's env (dt = 0.1) under the experiment's first exploration
# actions, uniform in [-20, 20], leaves float32's range at the same step in
# both packages (tests/golden/double_cartpole_explore.npz, held by
# tests/test_torch_example_scripts.py), so its trials, model and fit carry
# NaN; the script runs to its end all the same.
SCRIPT_NONFINITE = ("double_cartpole",)


def bf16_derived(out, plain, ref, floor):
    """f32_derived's rule for a float32 output under a bfloat16 knob:
    ``out`` against ``ref``, the float64 plain version of the same knob on
    the same inputs, within the larger of ``floor`` and twice the float32
    plain version ``plain``'s own distance to ``ref``, in two norms, each
    relative to ``ref``'s: the largest error, and the root mean square,
    which sees what the output's own rounding to bfloat16 under
    compute_dtype hides from the largest error (one flipped rounding there
    is as large as the knob's whole effect). No cap as f32_derived's: a
    bfloat16 net's own distance is up to ~2e-2 on AUX, and phase 20 shows
    instead that the full-precision kernel fails this rule."""
    import torch

    def rms(a, b):
        return float((a.double() - b).norm() / max(float(b.norm()),
                                                   1e-300))

    res = {}
    for norm, dist in (("max", lambda a, b: rel_err(a.double(), b)[1]),
                       ("rms", rms)):
        k, p = dist(out, ref), dist(plain, ref)
        tol = max(floor, 2.0 * p)
        res[norm] = {"kernel_vs_f64": k, "plain_vs_f64": p, "tol": tol,
                     "held": k <= tol}
    res["held"] = all(res[n]["held"] for n in ("max", "rms")) and bool(
        torch.isfinite(out).all())
    return res


def knob_model(model, knob):
    """``model`` with its net under ``knob`` = torch.bfloat16."""
    import copy

    import torch
    net = copy.copy(model.net)
    setattr(net, knob, torch.bfloat16)
    return model.replace(net=net)


def k2d_bf16_chain_cycles(n, nz, widths, P, dtype_name, codec=1):
    """k2d_chain_cycles with each layer's K-long FMA chain replaced, in
    float32, by its ceil(K / 16) dependent mma.sync (MMA_LATENCY each) and
    the epilogue's four roundings and adds; float64 keeps the FMA chain
    and adds the epilogue's."""
    lat = LATENCY[dtype_name]
    base = k2d_chain_cycles(n, nz, widths, P, dtype_name, codec)
    layers = len(widths) - 1
    if dtype_name == "float64":
        return base + 4 * layers * lat["fma"]
    fma_layers = (sum(widths[:-1]) + 2 * layers) * lat["fma"]
    mma = sum(-(-K // 16) * MMA_LATENCY + 4 * lat["fma"]
              for K in widths[:-1])
    return base - fma_layers + mma


def bf16_bound(model, B, N, A, dtype_name, codec, entry="K2(d)", G=10):
    """(bound ms, by, roofline ms, chain ms) of K2(d) (or F3) under a knob:
    float32 moves bfloat16 weights (half bnn_work's) and runs the MLP's
    products at PEAK_BF16_FLOPS, the rest at float32's peak; float64 as
    bnn_work at float64's peak. K2(d) adds its chain floor."""
    itemsize = 4 if dtype_name == "float32" else 8
    nbytes, flops = bnn_work(model, B, N, A, G, itemsize, codec)[entry]
    widths = [6, 200, 200, 8]
    products = 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    mlp = model.n_particles * products * (B * A * N if entry == "K2(d)"
                                          else G)
    if dtype_name == "float32":
        nbytes -= 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = mlp / PEAK_BF16_FLOPS + (flops - mlp) / PEAK_FLOPS["float32"]
        roof = 1e3 * max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
    else:
        roof, by = bound_ms(nbytes, flops, dtype_name)
    if entry != "K2(d)":
        return roof, by, roof, 0.0
    nz = {0: 20, 1: 14, 2: 8, 3: 8, 4: 4}[codec]
    chain = chain_ms(k2d_bf16_chain_cycles(4, nz, widths, model.n_particles,
                                           dtype_name, codec),
                     N, max_sm_clock_mhz())
    return max(roof, chain), (by if roof >= chain else "operations"), \
        roof, chain


def sass_functions(lib):
    """{function: [instruction, ...]} of ``cuobjdump -sass lib``, each
    instruction's text without its address and encoding."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            funcs[name].append(m.group(1))
    return funcs


def k2d_sass_report(lib):
    """The HMMA count of each float32 knob instance (K2(d)'s and F3's) and
    the instruction count of the Cholesky kernel at full precision
    (``scripts/torch_kernel_ab.py --bnn-only`` compares its SASS with
    another checkout's)."""
    funcs = sass_functions(lib)
    hmma = {}
    for name, ins in funcs.items():
        m = re.search(r"(bnn_rollout_codec_kernel|bnn_mlp_kernel)IfLi([12])E",
                      name)
        if m:
            hmma["{}<float, {}>".format(m.group(1), BF16_KNOBS[
                int(m.group(2)) - 1])] = sum("HMMA" in i for i in ins)
    chol = [ins for name, ins in funcs.items()
            if "bnn_rollout_kernelIfE" in name]
    check(len(chol) == 1, "no single bnn_rollout_kernel<float> in the SASS")
    return {"hmma": hmma, "chol_instructions": len(chol[0])}


def phase20a_f3(card):
    """20a: F3 under each knob against the net's plain forward at G=10
    groups of P=100 (6-200-200-8, phase 8's trained weights), in float64
    (BF16_F64_TOL) and float32 (bf16_derived against the float64 plain
    version of the float32 net, with the full-precision F3 on the same
    inputs required to fail it), timed beside its plain version and its
    bound."""
    import torch
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    rows, failed = [], []
    rng = np.random.default_rng(20)
    x64 = torch.as_tensor(rng.standard_normal((10, 100, 6)),
                          dtype=torch.float64, device="cuda")
    for dt in (torch.float64, torch.float32):
        dname = str(dt).replace("torch.", "")
        full = bnn_model(torch, dt, 25, True)
        x = x64.to(dt).contiguous()
        for knob in BF16_KNOBS:
            model = knob_model(full, knob)
            reset_counts(fb.launches)
            got = fb.mlp(model.net, x)
            plain = model.net(x)
            torch.cuda.synchronize()
            err = rel_err(got, plain)
            row = {"phase": "20a", "knob": knob, "dtype": dname,
                   "G": 10, "P": 100, "abs_err": err[0], "rel_err": err[1],
                   "launches": fb.launches["mlp"],
                   "finite": bool(torch.isfinite(got).all())}
            if dt == torch.float64:
                row["held"] = err[1] <= BF16_F64_TOL
            else:
                ref = cast_tree(model, torch.float64).net(x.double())
                row["check"] = bf16_derived(got, plain, ref, BF16_F32_FLOOR)
                row["full_precision_check"] = bf16_derived(
                    fb.mlp(full.net, x), plain, ref, BF16_F32_FLOOR)
                row["held"] = (row["check"]["held"]
                               and not row["full_precision_check"]["held"])
                raw = raw_bnn(torch, "mlp", model, dt, (x,))
                bound, by, _, _ = bf16_bound(model, 1, 25, 10, dname, 1,
                                             "F3")
                row.update(ms=events_ms(raw, 20),
                           plain_ms=events_ms(lambda: model.net(x), 20),
                           bound_ms=bound, bound_by=by,
                           plan=fb.launch_plan(model, 10, dt, None, "mlp"))
            row["held"] = row["held"] and row["finite"] and \
                row["launches"] == 1
            if not row["held"]:
                failed.append("20a {} {}: F3 off its plain version, or the "
                              "full-precision F3 as near: {}".format(
                                  knob, dname, row))
            emit(row)
            rows.append(row)
    return rows, failed


def bf16_codec_inputs(torch, enc, N=25):
    """Phase 19b's inputs under ``enc``, in float32 and, cast up, in
    float64: the full-precision trained model, the rollout of U = 0.1
    from bnn_start's state, its local model and K1's gains at the first
    finite reg of (1, 10, 100, 1e3). Returns {dtype: (model, (Z, U, k,
    K), alphas)} and the reg."""
    from pddp_tpu_torch.controllers.ilqr import (default_fit_alphas,
                                                 local_model, rollout)
    from pddp_tpu_torch.encoding import encode
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    f32, f64 = torch.float32, torch.float64
    model = bnn_model(torch, f32, N, True)
    cost = CartpoleCost(device="cuda", dtype=f32)
    z0 = encode(torch.zeros(4, dtype=f32, device="cuda"),
                V=1e-2 * torch.ones(4, dtype=f32, device="cuda"),
                encoding=enc)
    U = torch.full((N, 1), 0.1, dtype=f32, device="cuda")
    Z, AUX = rollout(model, z0, U, enc)
    derivs = local_model(Z, U, AUX, model, cost, enc)
    k, K, reg = k1_first_finite(derivs, (1.0, 10.0, 100.0, 1e3))
    check(k is not None, "20b: K1's gains finite at no reg")
    ins = (derivs[0], U, k, K)
    alphas = default_fit_alphas(f32, "cuda")
    return {f32: (model, ins, alphas),
            f64: (cast_tree(model, f64), tuple(t.double() for t in ins),
                  alphas.double())}, reg


def phase20b_k2d(card):
    """20b: under each knob and each codec, the line search of one
    iteration (bf16_codec_inputs; K2(d) with the cost as a post-pass and
    the argmin, every count from zero) against control_law on the same
    inputs, float64 within BF16_F64_TOL; float32 by bf16_derived against
    the float64 rows' plain version (the float32 model and inputs cast
    up), with the full-precision K2(d) on the same inputs required to
    fail it; float32 timed alone at B=1 and 64 beside its bound, its plan
    and, in the same call, the full-precision instance."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import control_law
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.ops import fused_bnn_rollout as fb
    from pddp_tpu_torch.ops import fused_rollout as fr
    rows, failed = [], []
    rng = np.random.default_rng(21)
    N = 25
    for codec in BF16_CODECS:
        enc = StateEncoding[codec]
        t_codec = time.perf_counter()
        cases, reg = bf16_codec_inputs(torch, enc, N)
        plain64 = {}
        for dt in (torch.float64, torch.float32):
            dname = str(dt).replace("torch.", "")
            full, ins, alphas = cases[dt]
            cost = CartpoleCost(device="cuda", dtype=dt)
            for knob in BF16_KNOBS:
                model = knob_model(full, knob)
                reset_all_counts()
                out, best = line_search_with_argmin(model, cost, *ins,
                                                    alphas, enc)
                torch.cuda.synchronize()
                launches = read_counts()["K2(d)"]
                got = (out[0], out[1], out[3])
                plain, plain_ms = timed_call(lambda: control_law(
                    model, *ins, alphas, enc, with_aux=True))
                torch.cuda.synchronize()
                row = {"phase": "20b", "knob": knob, "codec": codec,
                       "dtype": dname, "N": N, "P": 100, "A": 10,
                       "reg": reg, "launches": launches, "best": best,
                       "finite": all(bool(torch.isfinite(t).all())
                                     for t in got)}
                errs = {name: rel_err(a, p) for name, a, p in
                        zip(("Z", "U", "AUX"), got, plain)}
                row["errors"] = errs
                row["max_abs_err"] = max(e[0] for e in errs.values())
                if dt == torch.float64:
                    row["held"] = all(e[1] <= BF16_F64_TOL
                                      for e in errs.values())
                    plain64[knob] = plain
                else:
                    out_full = fr.fused_control_law(
                        full, *ins, alphas, enc, cost=cost, with_aux=True)
                    ref = plain64[knob]
                    row["check"] = {
                        name: bf16_derived(a, p, r, BF16_F32_FLOOR)
                        for name, a, p, r in zip(("Z", "U", "AUX"), got,
                                                 plain, ref)}
                    row["full_precision_check"] = {
                        name: bf16_derived(a, p, r, BF16_F32_FLOOR)
                        for name, a, p, r in zip(
                            ("Z", "U", "AUX"),
                            (out_full[0], out_full[1], out_full[3]), plain,
                            ref)}
                    row["held"] = (
                        all(v["held"] for v in row["check"].values())
                        and not all(v["held"] for v in
                                    row["full_precision_check"].values()))
                    Zn, U, k, K = ins
                    one = (Zn[None], U[None], k[None], K[None], alphas)
                    many = batch_of(rng, Zn, U, k, K, 64) + (alphas,)
                    b1 = bf16_bound(model, 1, N, 10, dname, int(enc))
                    b64 = bf16_bound(model, 64, N, 10, dname, int(enc))
                    row.update(
                        ms=events_ms(raw_bnn(torch, "rollout", model, dt,
                                             one, enc), 20),
                        ms_B64=events_ms(raw_bnn(torch, "rollout", model,
                                                 dt, many, enc), 5),
                        plain_ms=plain_ms, bound_ms=b1[0], bound_by=b1[1],
                        roofline_ms=b1[2], chain_floor_ms=b1[3],
                        bound_ms_B64=b64[0], bound_by_B64=b64[1],
                        plan=fb.launch_plan(model, 10, dt, enc),
                        plan_B64=fb.launch_plan(model, 640, dt, enc))
                    if knob == BF16_KNOBS[0]:
                        row["full_precision_ms"] = events_ms(raw_bnn(
                            torch, "rollout", full, dt, one, enc), 20)
                        row["full_precision_ms_B64"] = events_ms(raw_bnn(
                            torch, "rollout", full, dt, many, enc), 5)
                row["held"] = (row["held"] and row["finite"]
                               and launches == 1)
                if not row["held"]:
                    failed.append("20b {} {} {}: K2(d) off its plain "
                                  "version, or the full-precision K2(d) "
                                  "as near: {}".format(knob, codec, dname,
                                                       row))
                row["codec_seconds"] = time.perf_counter() - t_codec
                emit(row)
                rows.append(row)
    return rows, failed


def phase20c_iteration(card):
    """20c: one BNN iteration under each knob in float32 at full width
    (phase 8's: trained 6-200-200-8, P=100, N=25, A=10, the Cholesky
    codec): the rollout, the local model through the knob net's
    Jacobians, K1 at nz=14, K2(d)'s bfloat16 instance with the cost as a
    post-pass, the argmin; every count from zero, then timed (one turn,
    host clock) beside the same iteration through the plain versions."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (backward, control_law,
                                                 default_fit_alphas,
                                                 local_model, rollout,
                                                 trajectory_cost)
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.examples.cartpole import CartpoleCost
    from pddp_tpu_torch.ops import backward_kernel as bk
    ch = StateEncoding.UPPER_TRIANGULAR_CHOLESKY
    dt, N = torch.float32, 25
    rows, failed = [], []
    cost = CartpoleCost(device="cuda", dtype=dt)
    alphas = default_fit_alphas(dt, "cuda")
    for knob in BF16_KNOBS:
        model = knob_model(bnn_model(torch, dt, N, True), knob)
        z0, U0 = bnn_start(torch, dt, N)

        def iteration(kernels):
            Z0, AUX0 = rollout(model, z0, U0, ch)
            derivs = local_model(Z0, U0, AUX0, model, cost, ch)
            if kernels:
                k, K, reg = k1_first_finite(derivs, (1.0, 10.0, 100.0))
                out, best = line_search_with_argmin(model, cost, derivs[0],
                                                    U0, k, K, alphas, ch)
                return out, best, reg
            for reg in (1.0, 10.0, 100.0):
                k, K, ok = backward(*derivs, reg=reg)
                if bool(ok):
                    break
            Z_b, U_b, AUX_b = control_law(model, derivs[0], U0, k, K,
                                          alphas, ch, with_aux=True)
            J = trajectory_cost(cost, Z_b, U_b, ch)
            best = int(torch.argmin(torch.where(torch.isfinite(J), J,
                                                torch.inf)))
            return (Z_b, U_b, J, AUX_b), best, reg

        reset_all_counts()
        out, best, reg = iteration(True)
        torch.cuda.synchronize()
        counts = read_counts()
        row = {"phase": "20c", "knob": knob, "dtype": "float32", "N": N,
               "P": 100, "A": 10, "reg": reg, "best": best,
               "launches": counts}
        ok = (counts["K1"] >= 1 and counts["K2(d)"] == 1
              and tuple(out[0].shape) == (N + 1, 10, 14)
              and bool(torch.isfinite(out[0][:, best]).all())
              and bool(torch.isfinite(out[2][best])))
        walls = {}
        for kernels in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iteration(kernels)
            torch.cuda.synchronize()
            walls["kernels" if kernels else "plain"] = \
                1e3 * (time.perf_counter() - t0)
        row.update(iteration_ms=walls["kernels"],
                   plain_iteration_ms=walls["plain"], held=ok)
        if not ok:
            failed.append("20c {}: the iteration did not run through K1 "
                          "and K2(d): {}".format(knob, row))
        emit(row)
        rows.append(row)
    return rows, failed


def phase20d_scripts(card):
    """20d: each examples_torch script through its own run or main on
    the card at SCRIPT_CUTS, no matplotlib (the card's machine has none):
    its wall (host clock to synchronize) and the K1 and K2 launches it
    made, every count from zero; its outputs finite."""
    import functools

    import torch
    from examples_torch import (animation, cartpole, double_cartpole,
                                experiment, known_dynamics, mpc_animation,
                                parallel_solves, pendulum)
    from pddp_tpu_torch.controllers import PDDPController
    from pddp_tpu_torch.examples.problems import SampleProblems
    saved = sys.modules.get("matplotlib", False)
    sys.modules["matplotlib"] = None   # the scripts then draw nothing
    cut = SCRIPT_CUTS["experiment"]

    class CutTrials(PDDPController):
        """PDDPController with each MPC trial cut to its first ticks."""

        def _apply_controller(self, controller, H, *args, **kwargs):
            if kwargs.get("mpc"):
                H = min(H, cut["mpc_ticks"])
            return super()._apply_controller(controller, H, *args,
                                             **kwargs)

    def finite(tree):
        if hasattr(tree, "J_opt"):    # an ILQRResult
            return finite(tree.J_opt)
        if isinstance(tree, torch.Tensor):
            return bool(torch.isfinite(tree).all())
        if isinstance(tree, (list, tuple)):
            return all(finite(t) for t in tree)
        return True

    def known():
        return [known_dynamics.run(p, device="cuda",
                                   **SCRIPT_CUTS["known_dynamics"])
                for p in SampleProblems]

    def pddp(script):
        def go():
            if script is experiment:
                return experiment.run(
                    SampleProblems.CARTPOLE, max_trials=cut["max_trials"],
                    n_iterations=cut["n_iterations"], quiet=True,
                    device="cuda")[:3]
            return script.main(["--device", "cuda"])[:3]
        return go

    def animate(script):
        def go():
            script.ITERATIONS = SCRIPT_CUTS[script.__name__.split(".")[-1]][
                "iterations"]
            return script.main(["--device", "cuda"])
        return go

    runs = [("known_dynamics", known),
            ("experiment", pddp(experiment)),
            ("cartpole", pddp(cartpole)),
            ("pendulum", pddp(pendulum)),
            ("double_cartpole", pddp(double_cartpole)),
            ("parallel_solves", lambda: parallel_solves.main(
                ["--device", "cuda"])),
            ("animation", animate(animation)),
            ("mpc_animation", animate(mpc_animation))]
    rows, failed = [], []
    patched = {"PDDPController": experiment.PDDPController,
               "run": experiment.run, "TRAIN_N_ITER": experiment.TRAIN_N_ITER,
               "ITERATIONS": (animation.ITERATIONS,
                              mpc_animation.ITERATIONS),
               "OPTIONS": parallel_solves.OPTIONS}
    parallel_solves.OPTIONS = SCRIPT_CUTS["parallel_solves"]
    experiment.PDDPController = CutTrials
    experiment.TRAIN_N_ITER = cut["train_n_iter"]
    experiment.run = functools.partial(
        patched["run"], max_trials=cut["max_trials"],
        n_iterations=cut["n_iterations"], quiet=True)
    try:
        for name, fn in runs:
            reset_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn()
                torch.cuda.synchronize()
                ok, err = finite(out), None
            except Exception as e:  # reported, and the phase fails
                ok, err = False, "{}: {}".format(type(e).__name__, e)
            counts = read_counts()
            row = {"phase": "20d", "script": "examples_torch/{}.py".format(
                name), "wall_s": time.perf_counter() - t0,
                "launches": counts, "finite": ok,
                "cut": SCRIPT_CUTS.get(name, cut)}
            k2 = sum(counts["K2(" + st + ")"] for st in "abc")
            if err is None and name in SCRIPT_FUSED and k2 == 0:
                err = "fused_rollout set and no K2 launch"
            if err is not None:
                row["error"] = err[:2000]
            if err is not None or (not ok
                                   and name not in SCRIPT_NONFINITE):
                failed.append("20d {}: {}".format(name, err or
                                                  "non-finite output"))
            emit(row)
            rows.append(row)
    finally:
        experiment.PDDPController = patched["PDDPController"]
        experiment.run = patched["run"]
        experiment.TRAIN_N_ITER = patched["TRAIN_N_ITER"]
        animation.ITERATIONS, mpc_animation.ITERATIONS = \
            patched["ITERATIONS"]
        parallel_solves.OPTIONS = patched["OPTIONS"]
        if saved is False:
            del sys.modules["matplotlib"]
        else:
            sys.modules["matplotlib"] = saved
    return rows, failed


def phase20_bf16(card):
    """Phase 20 (20a-20d, then {"phase": 20, "seconds"}): K2(d) and F3
    under the BNN's bfloat16 knobs, and the examples_torch scripts."""
    t0 = time.perf_counter()
    f3, failed = phase20a_f3(card)
    k2d, more = phase20b_k2d(card)
    failed += more
    it, more = phase20c_iteration(card)
    failed += more
    scripts, more = phase20d_scripts(card)
    failed += more
    emit({"phase": 20, "seconds": time.perf_counter() - t0,
          "failed": failed})
    check(not failed, "phase 20: {}".format(failed))
    return {"f3": f3, "k2d": k2d, "iteration": it, "scripts": scripts}


# ---------------------------------------------------------------------------
# Phase 21: K2(f), the line search of any stateless model and cost, traced
# ---------------------------------------------------------------------------

#: the horizon and candidates of 21b, 21c and 21e (bench.py:163-184's
#: iteration: H=200, the ten default fit alphas).
TRACED_H = 200
#: 21b's float64 tolerance (relative, Z, U and J): K2(a)-(c)'s own
#: against the plain version (phase 10 holds them to 1e-12; the traced
#: programs take torch's order of operations, the same bound holds).
TRACED_F64_TOL = 1e-10
#: 21c's float64 tolerance: K2(f) against K2(a)-(c) on the exact examples.
TRACED_EXACT_TOL = 1e-12
#: 21c's exact examples: row -> (label, the hand-written stage).
TRACED_EXACT = {"R5": ("cartpole", "a"), "R6": ("double_cartpole", "b"),
                "R7": ("rendezvous_chol", "c"),
                "R8": ("constrained_cartpole", "a")}
#: 21b's path run per row: a float32 solve through K1 and K2(f), whose
#: K2(f) launches (= its evaluations) the kernels line carries and whose
#: first iterate gives the row's line-search inputs. It takes no
#: action bounds, so that the backward is K1 (with R1's, pddp_tpu's gate
#: sends it to the box-QP scan, ~10 s an evaluation on the card's host);
#: 21b's checks clamp R1 to its bounds.
TRACED_PATH_OPTS = {"n_iterations": 1, "max_evals": 4}
#: 21d's quadrotor solve (R1's model and cost at H=200, without R1's
#: action bounds, so that the backward is K1: with them pddp_tpu's gate
#: sends it to the box-QP scan), float64 on the card against the CPU's
#: plain solve (made in cpu_references beside the build).
TRACED_SOLVE_OPTS = {"n_iterations": 5}
TRACED_J_RTOL = 1e-10
#: 21d's batch: 21d's quadrotor problem at B=256 (starts perturbed by
#: 0.05), H=200, 5 iterations (bench.py's batched options), through K1
#: and K2(f), the first lanes against the scan (K1 the backward of both,
#: so that they differ in the line search alone: the plain backward at
#: nu=2 made the scan's lanes 27 s of phase 21's 67 on the H100).
TRACED_BATCH = {"B": 256, "lanes": 4, "n_iterations": 5, "max_evals": 15}


def traced_models():
    """tests/traced_models.py (the rows; it imports the port only)."""
    sys.path.insert(0, ROOT)
    from tests import traced_models
    return traced_models


def traced_problem(row, device, dtype, H=TRACED_H):
    """(model, cost, encoding, (u_min, u_max) tensors or (None, None),
    z0, U0) of a row at horizon H: the row's start under its codec (the
    belief, 1e-2 I), U0 the quadrotor's hover or the examples' 0.1."""
    import torch
    from pddp_tpu_torch.encoding import encode
    tm = traced_models()
    model, cost, enc, bounds = tm.make_row(row, H, device, dtype)
    name = tm.example_name(tm.ROWS[row][0])
    n, nu = model.state_size, model.action_size
    x0 = torch.tensor(tm.STARTS[name][1], dtype=dtype, device=device)
    z0 = encode(x0, V=1e-2 * torch.ones(n, dtype=dtype, device=device),
                encoding=enc)
    U0 = torch.full((H, nu), tm.HOVER if name == "quadrotor" else 0.1,
                    dtype=dtype, device=device)
    lo = hi = None
    if bounds is not None:
        lo, hi = (torch.tensor(b, dtype=dtype, device=device)
                  for b in bounds)
    return model, cost, enc, (lo, hi), z0, U0


def traced_path(row, rng):
    """A row's path run and line-search inputs: one float32 ``solve``
    (TRACED_PATH_OPTS, no bounds) through K1 and K2(f), its launches read
    around it, then the local model of its first iterate (its first
    evaluation's: at the result of a solve that converges in one
    iteration, as rendezvous's linear-quadratic one does, the gains are
    zero) and the gains of ``traced_gains``'s ladder, of which the row
    takes the first whose candidates the plain version computes in
    float32 within TRACED_CONDITION of float64 and that move the
    candidates (TRACED_SPREAD): the first reg at which the backward
    succeeds alone left R5's closed loop amplifying float32's rounding
    0.22-fold in one call and not in another (inputs no float32 check
    can read), and a reg past the ladder leaves gains near zero. The
    ladder's first reg is judged as solve 0 of 21b's batch (``batch_of``:
    the gains perturbed per solve but for solve 0), the others, where it
    fails, in one batch of their own.
    Returns (model, cost, encoding, the row's bounds, the B=1 inputs (Z,
    U, k, K) or None where no reg qualifies, the B=64 batch, the float32
    and float64 plain versions' outputs on it, the float32 one's ms, the
    solve's ends and launches, the ladder's record)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (ILQROptions,
                                                 default_fit_alphas,
                                                 local_model, rollout,
                                                 solve)
    f32 = torch.float32
    model, cost, enc, bounds, z0, U0 = traced_problem(row, "cuda", f32)
    opts = ILQROptions(**TRACED_PATH_OPTS, riccati_mode="kernel",
                       fused_rollout=True)
    reset_all_counts()
    r = solve(model, cost, z0, U0, opts, encoding=enc)
    torch.cuda.synchronize()
    path = {**_ends(r), "launches": read_counts()}
    derivs = local_model(rollout(model, z0, U0, enc)[0], U0, (), model,
                         cost, enc)
    a32 = default_fit_alphas(f32, "cuda")
    m64, c64, b64 = cast_up(model), cast_up(cost), _bounds64(bounds)
    regs, k, K = traced_gains(derivs, 0.0)
    record = {"regs": regs[:1] + regs[-1:], "reg": None}

    def at(lane):
        return (derivs[0], U0, k[lane].contiguous(), K[lane].contiguous())

    def around(ins):
        """21b's batch: solve 0 ``ins``, the others its gains perturbed."""
        batch = batch_of(rng, *ins, 64)
        for t, t1 in zip(batch, ins):
            t[0] = t1
        return batch

    def plain(batch):
        p32, ms = timed_call(lambda: traced_plain(model, cost, *batch, a32,
                                                  enc, bounds))
        p64 = traced_plain(m64, c64, *(t.double() for t in batch),
                           a32.double(), enc, b64)
        return p32, p64, ms

    def qualifies(p32, p64, j, lane):
        own = max(rel_err(a[j].double(), b[j])[1] for a, b in zip(p32, p64))
        spread = rel_err(p64[1][j][:, 0], p64[1][j][:, -1])[1]
        record.update(reg=regs[lane], own_distance=own, spread=spread)
        return (all(bool(torch.isfinite(a[j]).all()) for a in p32)
                and own <= TRACED_CONDITION and spread >= TRACED_SPREAD)

    out = (model, cost, enc, bounds)
    if not regs:
        return out + (None, None, None, None, None, path, record)
    batch = around(at(0))
    p32, p64, ms = plain(batch)
    if qualifies(p32, p64, 0, 0):
        return out + (at(0), batch, p32, p64, ms, path, record)
    rest = list(range(1, len(regs)))
    ladder = tuple(torch.stack([at(j)[q] for j in rest])
                   for q in range(4))
    q32, q64, _ = plain(ladder)
    for j, lane in enumerate(rest):
        if qualifies(q32, q64, j, lane):
            batch = around(at(lane))
            return out + (at(lane), batch, *plain(batch), path, record)
    return out + (None, None, None, None, None, path, record)


#: traced_path's ladder: K1's gains at the first reg, doubled from 1e-6,
#: at which K1 succeeds, then at each of this many doublings after it.
TRACED_LADDER = 20
#: the largest relative distance between the plain version's float32 and
#: float64 candidates at which traced_path takes a reg's gains: past it
#: the closed loop amplifies rounding (R5's at reg 4.1 did 0.22-fold on
#: the H100), and no float32 check could read the kernel.
TRACED_CONDITION = 1e-3
#: the least relative distance between a row's float64 actions at the
#: largest and the smallest alpha at which traced_path takes its gains.
TRACED_SPREAD = 1e-3


def traced_gains(derivs, mu):
    """K1's gains of the local model ``derivs`` at 64 regs doubled from
    max(mu, 1e-6) (one batched call, a solve a reg): (regs, k, K) from the
    first reg at which K1 succeeds to TRACED_LADDER doublings after it;
    the regs empty where it succeeds at none."""
    import torch
    from pddp_tpu_torch.ops.backward_kernel import kernel_backward
    n = 64
    regs = max(mu, 1e-6) * 2.0 ** torch.arange(
        n, dtype=derivs[1].dtype, device=derivs[1].device)
    k, K, ok = kernel_backward(*(t.expand((n,) + t.shape).contiguous()
                                 for t in derivs), reg=regs)
    good = ok.nonzero().flatten().tolist()
    if not good:
        return [], k[:0], K[:0]
    lanes = slice(good[0], min(n, good[0] + TRACED_LADDER + 1))
    return regs[lanes].tolist(), k[lanes], K[lanes]


def cast_up(obj):
    """A copy of a model or cost with every tensor attribute in float64
    (K2(f)'s leaves, through the trace's own walk)."""
    import torch
    from pddp_tpu_torch.ops import _trace
    leaves = _trace.leaves_of(obj)[0]
    return _trace._substitute(obj, iter([t.to(torch.float64)
                                         for t in leaves]))


def traced_build_jobs():
    """21a's traces: every row's K2(f) rollout in float32 and float64 on
    the card (``traced_rollout.traced``; cached, so the phase's calls
    reuse them), with its seconds, and those of 21c's exact examples
    (their text is their row's, so they share its library). Returns
    {(row, dtype name): (traced rollout, the generated source)}."""
    import torch
    from pddp_tpu_torch.ops import traced_rollout as tro
    tm = traced_models()
    out = {}
    for row in tm.ROWS:
        for dt in (torch.float32, torch.float64):
            model, cost, enc, _, _, _ = traced_problem(row, "cuda", dt)
            tr = tro.traced(model, cost, enc, dt, "cuda")
            out[row, str(dt).replace("torch.", "")] = (
                tr, tro.source_text(tr))
            if row in TRACED_EXACT:
                tro.traced(exact_example(model, row, dt), cost, enc, dt,
                           "cuda")
    return out


def exact_example(model, row, dtype):
    """The exact example a row's user subclass extends (R8: the class
    constrain_model(-1, 1) built), at the row's time step."""
    tm = traced_models()
    base = type(model).__mro__[1]
    return base(dt=tm.STARTS[tm.example_name(tm.ROWS[row][0])][0],
                device="cuda", dtype=dtype)


def traced_builds(after):
    """21a's and 22a's build: traces the rows of phases 21 and 22, then,
    once ``after`` is set (phase 0's build done), builds their libraries
    (``_build.build_all``, one nvcc a distinct source, all at once) from
    this worker thread at the lowest priority (``os.nice`` acts on the
    calling thread alone, and the compilers it starts inherit it), so
    that they take only the cores the phases after phase 0 leave idle:
    (traces, build report)."""
    from pddp_tpu_torch.ops import _build
    t0 = time.perf_counter()
    traces = traced_build_jobs()
    trace_s = time.perf_counter() - t0
    stateful = stateful_build_jobs()
    stateful_s = time.perf_counter() - t0 - trace_s
    after.wait()
    os.nice(19)
    report = _build.build_all(
        generated=[(tr.name, text, tr.dtype) for tr, text in traces.values()]
        + [(name, text, tr.dtype, contract)
           for _, tr, name, text, contract in stateful.values()])
    return {"traces": traces, "trace_s": trace_s, "stateful": stateful,
            "stateful_trace_s": stateful_s}, report


def ptxas_rows(text):
    """Each kernel entry of an ``nvcc -Xptxas -v`` report: registers,
    shared memory, stack and spills."""
    rows, entry = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, frame = m.group(1), [0, 0, 0]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and entry is not None:
            frame = [int(g) for g in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"entry": entry, "registers": int(m.group(1)),
                         "smem_bytes": int(smem.group(1)) if smem else 0,
                         "stack_bytes": frame[0],
                         "spill_store_bytes": frame[1],
                         "spill_load_bytes": frame[2]})
            entry = None
    return rows


def phase21a_build(card, build):
    """21a: each library's trace seconds, nvcc seconds (all built at once
    after phase 0's build), ptxas's registers and spills, and the size of
    the traced step."""
    info, report = build
    rows = []
    for (row, dname), (tr, text) in info["traces"].items():
        r = report[tr.name]
        entries = ptxas_rows(r["ptxas"])
        check(r["ptxas"] == "" or any(
            "traced_rollout_kernel" in e["entry"] for e in entries),
              "{} {}: ptxas reported no K2(f) kernel".format(row, dname))
        rows.append({"row": row, "dtype": dname, "library": tr.name,
                     "trace_s": tr.trace_seconds, "nvcc_s": r["seconds"],
                     "ptxas": entries, "step_instructions": len(tr.step.ops),
                     "n_static": tr.n_static, "n_dynamic": tr.n_dynamic})
    emit({"phase": "21a", "card": card, "traces_s": info["trace_s"],
          "libraries": len({r["library"] for r in rows}), "rows": rows})
    return rows


def raw_k2f(model, cost, Z, U, k, K, alphas, enc, bounds=(None, None)):
    """A closure launching K2(f) alone on preallocated outputs (one solve
    or a batch; the cost in the kernel under IGNORE_UNCERTAINTY)."""
    import torch
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.ops import traced_rollout as tro
    if Z.dim() == 2:
        Z, U, k, K = (t[None] for t in (Z, U, k, K))
    ign = enc == StateEncoding.IGNORE_UNCERTAINTY
    kc = cost if ign else None
    tr = tro.traced(model, kc, enc, Z.dtype, "cuda")
    B, N, A = U.shape[0], U.shape[1], alphas.shape[0]
    nz, nu = Z.shape[-1], U.shape[-1]
    p, w = tr.buffers(model, kc, Z.dtype, Z.device)
    bnd = fr._bounds(*bounds, nu, Z.dtype, Z.device)
    outs = [torch.empty(s, dtype=Z.dtype, device=Z.device)
            for s in ((B, N + 1, A, nz), (B, N, A, nu), (B, A))]
    fn = tro._function(tr, Z.dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        check(fn(*(t.data_ptr() for t in (Z, U, k, K, alphas, p, w)),
                 None if bnd is None else bnd.data_ptr(),
                 outs[0].data_ptr(), outs[1].data_ptr(),
                 outs[2].data_ptr() if tr.has_cost else None, B, N, A,
                 None, None, stream) == 0, "K2(f) launch")
    return launch


def k2f_work(tr, B, N, A, itemsize, bounded):
    """(bytes, operations) of one K2(f) call: each input read once (the
    nominal rows, the alphas, the leaves), each output written once; per
    candidate and step the traced program's operations (``op_count``:
    the feedback law, the step, the stage cost), and the clamp's two."""
    nz, nu = tr.nz, tr.nu
    n_in = (B * ((N + 1) * nz + 2 * N * nu + N * nu * nz) + A + tr.n_static
            + tr.n_dynamic + (2 * nu if bounded else 0))
    n_out = B * ((N + 1) * A * nz + N * A * nu + (A if tr.has_cost else 0))
    ops = B * A * (N * (tr.op_count() + (2 * nu if bounded else 0))
                   + (tr.terminal.op_count() if tr.has_cost else 0))
    return (n_in + n_out) * itemsize, ops


def traced_call(model, cost, Z, U, k, K, alphas, enc, bounds):
    """``fused_control_law`` as a solve's line search calls it (the cost
    in the kernel under IGNORE_UNCERTAINTY, a post-pass otherwise)."""
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    ign = enc == StateEncoding.IGNORE_UNCERTAINTY
    return fr.fused_control_law(model, Z, U, k, K, alphas, enc,
                                cost=cost if ign else None, u_min=bounds[0],
                                u_max=bounds[1])


def traced_plain(model, cost, Z, U, k, K, alphas, enc, bounds):
    """The plain version, control_law, with the cost summed in its loop
    under IGNORE_UNCERTAINTY as the kernel sums it."""
    from pddp_tpu_torch.controllers.ilqr import control_law
    from pddp_tpu_torch.encoding import StateEncoding
    ign = enc == StateEncoding.IGNORE_UNCERTAINTY
    return control_law(model, Z, U, k, K, alphas, enc, u_min=bounds[0],
                       u_max=bounds[1], cost=cost if ign else None,
                       cost_in_scan=ign)


def _bounds64(bounds):
    return tuple(None if b is None else b.double() for b in bounds)


def phase21b_rows(card, rng):
    """21b: each row's path run (``traced_path``: a float32 solve at H=200
    through K1 and K2(f), K2(f)'s launches equal to its evaluations), then
    K2(f) against its plain version at its inputs (``traced_path``), ten
    alphas,
    B=1 and B=64 (the gains perturbed per solve but for solve 0, the B=1
    inputs, so that the plain version runs once for both), float64
    (TRACED_F64_TOL, the float32 model and inputs cast up) and float32
    (rest_f32: against that float64 plain version); and 21e: K2(f) alone
    at B=1 and 64 (float32, events over raw launches) beside its bound,
    the larger of the roofline and the traced step's chain
    (``k2f_chain_cycles``) x N at the card's maximum SM clock, with the
    plain version's time at B=64 (its launches do not depend on B)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    from pddp_tpu_torch.ops import traced_rollout as tro
    tm = traced_models()
    f32 = torch.float32
    rows, failed, inputs = [], [], {}
    for row in tm.ROWS:
        t0 = time.perf_counter()
        kind, codec, cost_kind = tm.ROWS[row]
        out = {"row": row, "model": kind, "codec": codec, "cost": cost_kind,
               "N": TRACED_H, "A": 10}
        (model32, cost32, enc, b32, ins32, batch, plain32, ref,
         out["plain_ms_B64"], path, ladder) = traced_path(row, rng)
        out["path"], out["ladder"] = path, ladder
        out["launches"] = path["launches"]["K2(f)"]
        if not (out["launches"] == path["evals"] > 0 and all(
                path["launches"]["K2(" + s + ")"] == 0 for s in "abcde")):
            failed.append("21b {}: the path's launches {} differ from its "
                          "{} evaluations".format(row, path["launches"],
                                                  path["evals"]))
        if ins32 is None:
            failed.append("21b {}: no reg of the ladder gives gains that "
                          "move the candidates and that float32 computes "
                          "within {} of float64: {}".format(
                              row, TRACED_CONDITION, ladder))
            emit({"phase": "21b", "card": card, **out})
            continue
        a32 = default_fit_alphas(f32, "cuda")
        m64, c64 = cast_up(model32), cast_up(cost32)
        b64 = _bounds64(b32)
        inputs[row] = (model32, cost32, enc, b32, ins32,
                       tuple(r[0] for r in ref),
                       tuple(p[0] for p in plain32))
        for B, ins in ((1, ins32), (64, batch)):
            def pick(outs):
                return outs if B == 64 else tuple(o[0] for o in outs)
            kern64 = traced_call(m64, c64, *(t.double() for t in ins),
                                 a32.double(), enc, b64)
            errs = rest_errors(kern64, pick(ref))
            kern32 = traced_call(model32, cost32, *ins, a32, enc, b32)
            hold = rest_f32(kern32, pick(plain32), pick(ref))
            f64_held = all(e[1] <= TRACED_F64_TOL for e in errs.values())
            out["B{}".format(B)] = {"float64": errs, "float64_held":
                                    f64_held, "float32": hold}
            if not f64_held:
                failed.append("21b {} B={}: float64 off the plain version: "
                              "{}".format(row, B, errs))
            if not all(v["held"] for v in hold.values()):
                failed.append("21b {} B={}: float32 past its derived "
                              "tolerance: {}".format(row, B, hold))
        out["max_abs_err"] = max(e[0] for e in
                                 out["B1"]["float64"].values())
        # 21e: the kernel alone beside its bound.
        tr = tro.traced(model32, cost32, enc, f32, "cuda")
        bounded = b32[0] is not None
        raw1 = raw_k2f(model32, cost32, *ins32, a32, enc, b32)
        raw64 = raw_k2f(model32, cost32, *batch, a32, enc, b32)
        cycles, chain = tr.chain(LATENCY["float32"], bounded)
        out.update(rest_row_times(
            raw1, raw64, k2f_work(tr, 1, TRACED_H, 10, 4, bounded),
            k2f_work(tr, 64, TRACED_H, 10, 4, bounded), cycles, TRACED_H,
            "float32"))
        out["chain_cycles"], out["chain"] = cycles, chain
        out["seconds"] = time.perf_counter() - t0
        emit({"phase": "21b", "card": card, **out})
        rows.append(out)
    return rows, failed, inputs


def phase21c_exact(card, rng, inputs):
    """21c: K2(f) called directly (``traced_control_law``) on the exact
    examples of R5-R8 (the cartpole, the double cartpole, rendezvous
    under the Cholesky codec, constrain_model(-1, 1)'s cartpole) against
    the hand-written K2(a), K2(b), K2(c) and K2(a)'s constrained instance
    on the same inputs (21b's rows'): float64 within TRACED_EXACT_TOL,
    float32 each held by ``rest_f32`` against 21b's plain version of the
    row in float32 and float64 (the same arithmetic on the same inputs:
    the derived tolerance is the plain version's, not the other
    kernel's), their distance to each other reported; both timed alone
    at B=1 and 64 in float32, in turns, in this call."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.ops import traced_rollout as tro
    f32 = torch.float32
    rows, failed = [], []
    for row, (label, st) in TRACED_EXACT.items():
        t0 = time.perf_counter()
        if row not in inputs:   # failed in 21b
            continue
        model32, cost32, enc, b32, ins32, ref, plain32 = inputs[row]
        exact = exact_example(model32, row, f32)
        check(fr.stage(exact, cost32, enc) == st,
              "21c {}: the exact example is not in K2({})".format(row, st))
        ign = enc == StateEncoding.IGNORE_UNCERTAINTY
        kc = cost32 if ign else None
        a32 = default_fit_alphas(f32, "cuda")
        out = {"row": row, "example": label, "stage": st}
        m64, c64 = cast_up(exact), cast_up(cost32)
        ins64 = tuple(t.double() for t in ins32)
        f_64 = tro.traced_control_law(m64, *ins64, a32.double(), enc,
                                      cost=c64 if ign else None)
        h_64 = fr.fused_control_law(m64, *ins64, a32.double(), enc,
                                    cost=c64 if ign else None)
        errs = rest_errors(f_64, h_64)
        out["float64"] = errs
        if not all(e[1] <= TRACED_EXACT_TOL for e in errs.values()):
            failed.append("21c {}: K2(f) off K2({}) in float64: {}".format(
                row, st, errs))
        f_32 = tro.traced_control_law(exact, *ins32, a32, enc, cost=kc)
        h_32 = fr.fused_control_law(exact, *ins32, a32, enc, cost=kc)
        out["float32"] = {"K2(f)": rest_f32(f_32, plain32, ref),
                          "K2({})".format(st): rest_f32(h_32, plain32, ref),
                          "K2(f)_vs_K2({})".format(st): rest_errors(f_32,
                                                                   h_32)}
        for name in ("K2(f)", "K2({})".format(st)):
            hold = out["float32"][name]
            if not all(v["held"] for v in hold.values()):
                failed.append("21c {}: {} float32 past its derived "
                              "tolerance: {}".format(row, name, hold))
        batch = batch_of(rng, *ins32, 64)
        raws = {"K2(f)": (raw_k2f(exact, cost32, *ins32, a32, enc),
                          raw_k2f(exact, cost32, *batch, a32, enc)),
                "K2({})".format(st): (raw_k2(exact, kc, *ins32, a32, enc),
                                      raw_k2(exact, kc, *batch, a32, enc))}
        times = {k: {"ms": [], "ms_B64": []} for k in raws}
        for name in list(raws) + list(raws)[::-1]:
            times[name]["ms"].append(events_ms(raws[name][0], 20))
            times[name]["ms_B64"].append(events_ms(raws[name][1], 5))
        out["times"] = {k: {q: float(np.median(v)) for q, v in t.items()}
                        for k, t in times.items()}
        out["seconds"] = time.perf_counter() - t0
        emit({"phase": "21c", "card": card, **out})
        rows.append(out)
    return rows, failed


def traced_cpu_solve():
    """21d's float64 reference on the CPU: the R1 quadrotor solve (no
    bounds) through the plain versions, the cost summed in the scan as
    K2(f) sums it."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    model, cost, enc, _, z0, U0 = traced_problem("R1", "cpu", torch.float64)
    return solve(model, cost, z0, U0, ILQROptions(
        **TRACED_SOLVE_OPTS, cost_in_scan=True), encoding=enc)


def phase21d_solves(card, cpu):
    """21d: (i) the golden cartpole case (tests/golden/cases.py) through
    R5's subclass of the cartpole, ``fused_rollout=True,
    riccati_mode="kernel"``, float64, against
    tests/golden/solver_trajectories.npz within test_golden.py's
    tolerances; (ii) the R1 quadrotor solve at H=200 (without R1's
    bounds), float64 on the card against the CPU's (the same end, J
    within TRACED_J_RTOL), and its float32 wall; (iii) one
    ``batched_solve`` of it at B=256, H=200, 5 iterations, float64,
    through K1 and K2(f), its first lanes against the same lanes through
    K1 and the scan on the card. Each run's K1 and K2(f) launches equal its
    evaluations (the batch: the batched loop's)."""
    import torch
    from pddp_tpu_torch.controllers import ilqr
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    from pddp_tpu_torch.convert import golden_cartpole_U0
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.parallel import batched_solve
    tm = traced_models()
    f32, f64 = torch.float32, torch.float64
    failed, out = [], {}
    t0 = time.perf_counter()
    # (i) The golden cartpole through the user's subclass.
    g = np.load(GOLDEN)
    _, _, iters, _, outcomes = GOLDEN_CASES["cartpole"]
    model = tm.user_subclass("cartpole_subclass")(dt=0.05, device="cuda",
                                                  dtype=f64)
    _, cost, z0 = cartpole_problem(torch, f64, "cuda", 60)
    U0 = torch.as_tensor(golden_cartpole_U0(), dtype=f64, device="cuda")
    reset_all_counts()
    r, sec = _timed(lambda: solve(
        model, cost, z0, U0, ILQROptions(n_iterations=iters,
                                         riccati_mode="kernel",
                                         fused_rollout=True),
        encoding=StateEncoding.IGNORE_UNCERTAINTY))
    counts = read_counts()
    Z, U = r.Z.cpu().numpy(), r.U.cpu().numpy()
    gold = {"case": "cartpole", "model": type(model).__name__,
            **_ends(r), "launches": counts, "solve_s": sec,
            "J_rel": abs(r.J_opt - float(g["cartpole_J"]))
            / abs(float(g["cartpole_J"])),
            "Z_abs": float(np.abs(Z - g["cartpole_Z"]).max()),
            "U_abs": float(np.abs(U - g["cartpole_U"]).max())}
    out["golden"] = gold
    try:
        np.testing.assert_allclose(r.J_opt, g["cartpole_J"], rtol=1e-6)
        np.testing.assert_allclose(Z, g["cartpole_Z"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(U, g["cartpole_U"], rtol=1e-5, atol=1e-7)
    except AssertionError as e:
        failed.append("21d golden cartpole: {}".format(str(e)[:300]))
    if (r.state.name, r.iterations, r.evals) not in outcomes:
        failed.append("21d golden cartpole ended {}, expected {}".format(
            _ends(r), outcomes))
    if not (counts["K2(f)"] == r.evals > 0 and counts["K1"] == r.evals
            and counts["K2(a)"] == 0):
        failed.append("21d golden cartpole launches {} for {} "
                      "evaluations".format(counts, r.evals))
    # (ii) The quadrotor solve, float64 against the CPU, float32 wall.
    quad = {}
    for dt in (f64, f32):
        model, cost, enc, _, z0, U0 = traced_problem("R1", "cuda", dt)
        opts = ILQROptions(**TRACED_SOLVE_OPTS, riccati_mode="kernel",
                           fused_rollout=True)
        reset_all_counts()
        r, sec = _timed(lambda: solve(model, cost, z0, U0, opts,
                                      encoding=enc))
        counts = read_counts()
        dname = str(dt).replace("torch.", "")
        quad[dname] = {**_ends(r), "wall_s": sec, "launches": counts}
        if not counts["K2(f)"] == counts["K1"] == r.evals > 0:
            failed.append("21d quadrotor {}: launches {} for {} "
                          "evaluations".format(dname, counts, r.evals))
        if dt == f64:
            quad["cpu"] = _ends(cpu)
            quad["J_rel"] = abs(r.J_opt - cpu.J_opt) / abs(cpu.J_opt)
            if not ((r.state, r.iterations, r.evals)
                    == (cpu.state, cpu.iterations, cpu.evals)
                    and quad["J_rel"] <= TRACED_J_RTOL):
                failed.append("21d quadrotor: the card's float64 solve "
                              "differs from the CPU's: {}".format(quad))
    out["quadrotor"] = quad
    # (iii) The batch through K1 + K2(f), lanes against the scan.
    B, lanes = TRACED_BATCH["B"], TRACED_BATCH["lanes"]
    model, cost, enc, _, z0, U0 = traced_problem("R1", "cuda", f64)
    gen = np.random.default_rng(5)
    z0s = (z0 + torch.as_tensor(0.05 * gen.standard_normal((B, z0.numel())),
                                dtype=f64, device="cuda")).contiguous()
    U0s = U0.expand(B, *U0.shape).contiguous()
    kw = dict(n_iterations=TRACED_BATCH["n_iterations"],
              max_evals=TRACED_BATCH["max_evals"])
    reset_all_counts()
    ilqr.lane_evaluations = 0
    rk, sec = _timed(lambda: batched_solve(
        model, cost, z0s, U0s, ILQROptions(**kw, riccati_mode="kernel",
                                           fused_rollout=True,
                                           cost_in_scan=True),
        encoding=enc))
    counts, evals = read_counts(), ilqr.lane_evaluations
    rs, scan_s = _timed(lambda: batched_solve(
        model, cost, z0s[:lanes], U0s[:lanes],
        ILQROptions(**kw, riccati_mode="kernel", cost_in_scan=True),
        encoding=enc))
    cmp = ends_and_J(rs, rk, lanes)
    batch = {"B": B, "H": TRACED_H, "wall_s": sec, "launches": counts,
             "evaluations": evals, "ends": _lane_ends(rk), "vs_scan": cmp,
             "scan_lanes_wall_s": scan_s}
    out["batch"] = batch
    if not counts["K2(f)"] == counts["K1"] == evals > 0:
        failed.append("21d batch: K1 and K2(f) launches {} for {} batched "
                      "evaluations".format(counts, evals))
    if cmp["other_ends"] or not (cmp["J_rel_same_ends"] is not None
                                 and cmp["J_rel_same_ends"]
                                 <= TRACED_J_RTOL):
        failed.append("21d batch: lanes off the scan: {}".format(cmp))
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "21d", "card": card, **out})
    return out, failed


def phase21_traced(card, build, cpu):
    """Phase 21, K2(f) on the card: 21a the traced libraries' build, 21b
    each row against the plain version with its path run and (21e) its
    times and bound, 21c the exact examples against K2(a)-(c), 21d the
    solves."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(2121)
    a = phase21a_build(card, build)
    b, failed, inputs = phase21b_rows(card, rng)
    c, more = phase21c_exact(card, rng, inputs)
    failed += more
    d, more = phase21d_solves(card, cpu)
    failed += more
    emit({"phase": 21, "seconds": time.perf_counter() - t0,
          "failed": failed})
    check(not failed, "phase 21: {}".format(failed))
    return {"build": a, "rows": b, "exact": c, "solves": d}


# ---------------------------------------------------------------------------
# Phase 22: K2(g), a user's stateful model traced, and K2(e) over a traced
# inner step
# ---------------------------------------------------------------------------

#: each stateful row kind's horizon at full width: K2(g)'s rows at bench.py's
#: H=200, K2(e)'s at phase 17's N=50 with its P=100 particles.
STATEFUL_H = {"G": TRACED_H, "E": PARTICLE_N}
STATEFUL_P = PARTICLE_P
#: 22d's solve of G1 (its model and cost without its bounds, so that the
#: backward is K1; a stateful model's line search stays on the scan, as
#: in pddp_tpu's solve), float64 on the card against the CPU's plain solve
#: (made in cpu_references beside the build).
STATEFUL_SOLVE_OPTS = {"n_iterations": 3}
#: the rows whose float32 kernel 22b holds at B=64 as at B=1 (phase 21's
#: practice). E1's only at B=1, as phase 19a holds K2(e), its B=64
#: float32 distances reported: there the particle cartpole's noise solve
#: under the Cholesky codec amplifies float32's rounding in the aux (the
#: inferred noise) to 0.4-1.0 % in the plain version itself on every batch
#: of gains perturbed by 1 % that the ladder offered (its solve 0 at
#: 0.06-0.09 %), so that two float32 computations of it differ by more
#: than F32_DERIVED_CAP; float64 holds every row at B=64.
STATEFUL_F32_B64 = ("G1", "G2", "G3", "E2")


def stateful_problem(row, device, dtype):
    """(model, cost, encoding, (u_min, u_max) tensors or (None, None), z0,
    U0) of a stateful row at full width (STATEFUL_H, STATEFUL_P): the
    row's start under its codec (the belief, 1e-2 I), U0 the quadrotor's
    hover or the cartpole's 0.1."""
    import torch
    from pddp_tpu_torch.encoding import encode
    tm = traced_models()
    model, cost, enc, bounds = tm.make_stateful_row(
        row, STATEFUL_H[row[0]], device, dtype, P=STATEFUL_P)
    name = tm.example_name(tm.STATEFUL_ROWS[row][0])
    n, nu = model.state_size, model.action_size
    x0 = torch.tensor(tm.STARTS[name][1], dtype=dtype, device=device)
    z0 = encode(x0, V=1e-2 * torch.ones(n, dtype=dtype, device=device),
                encoding=enc)
    U0 = torch.full((STATEFUL_H[row[0]], nu),
                    tm.HOVER if name == "quadrotor" else 0.1, dtype=dtype,
                    device=device)
    lo = hi = None
    if bounds is not None:
        lo, hi = (torch.tensor(b, dtype=dtype, device=device)
                  for b in bounds)
    return model, cost, enc, (lo, hi), z0, U0


def stateful_trace(row, dtype):
    """(kind, traced, library name, generated source, contract) of a
    stateful row's kernel in ``dtype``: "g", K2(g)'s TracedRollout, or
    "e", the TracedInner of K2(e)'s generated instance."""
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    from pddp_tpu_torch.ops import traced_rollout as tro
    model, cost, enc, _, _, _ = stateful_problem(row, "cuda", dtype)
    if row.startswith("G"):
        kc = cost if enc == StateEncoding.IGNORE_UNCERTAINTY else None
        tr = tro.traced(model, kc, enc, dtype, "cuda", allow_stateful=True)
        return "g", tr, tr.name, tro.source_text(tr), False
    tr = fpr.inner_step(model.inner, dtype, "cuda")
    text = fpr.traced_source(tr, enc)
    return "e", tr, fpr.traced_name(text), text, True


def stateful_build_jobs():
    """22a's traces: every stateful row's kernel in float32 and float64
    (cached, so the phase's calls reuse them). Returns {(row, dtype
    name): stateful_trace's tuple}."""
    import torch
    tm = traced_models()
    return {(row, str(dt).replace("torch.", "")): stateful_trace(row, dt)
            for row in tm.STATEFUL_ROWS
            for dt in (torch.float32, torch.float64)}


def phase22a_build(card, build):
    """22a: each stateful library's trace seconds, nvcc seconds (built
    with phase 21's after phase 0), ptxas's registers and spills, the
    traced step's size."""
    info, report = build
    rows = []
    for (row, dname), (kind, tr, name, _, _) in info["stateful"].items():
        r = report[name]
        entries = ptxas_rows(r["ptxas"])
        want = ("traced_rollout_kernel" if kind == "g"
                else "particle_rollout_kernel")
        check(r["ptxas"] == "" or any(want in e["entry"] for e in entries),
              "{} {}: ptxas reported no {}".format(row, dname, want))
        rows.append({"row": row, "dtype": dname, "library": name,
                     "kernel": "K2(g)" if kind == "g" else "K2(e) traced",
                     "trace_s": tr.trace_seconds, "nvcc_s": r["seconds"],
                     "ptxas": entries, "step_instructions": len(tr.step.ops),
                     "n_static": tr.n_static, "n_dynamic": tr.n_dynamic})
    emit({"phase": "22a", "card": card,
          "traces_s": info["stateful_trace_s"],
          "libraries": len({r["library"] for r in rows}), "rows": rows})
    return rows


def stateful_plain(model, cost, Z, U, k, K, alphas, enc, bounds):
    """The plain version, control_law with the aux, the cost summed in
    its loop under IGNORE_UNCERTAINTY (as K2(g) sums it), else a
    post-pass."""
    from pddp_tpu_torch.controllers.ilqr import control_law
    from pddp_tpu_torch.encoding import StateEncoding
    return control_law(model, Z, U, k, K, alphas, enc, u_min=bounds[0],
                       u_max=bounds[1], cost=cost, with_aux=True,
                       cost_in_scan=enc == StateEncoding.IGNORE_UNCERTAINTY)


def stateful_call(model, cost, Z, U, k, K, alphas, enc, bounds):
    """``fused_control_law`` as one iteration calls it on a stateful
    model (``allow_stateful``: K2(g) or K2(e)), with the cost and aux."""
    from pddp_tpu_torch.ops import fused_rollout as fr
    return fr.fused_control_law(model, Z, U, k, K, alphas, enc, cost=cost,
                                u_min=bounds[0], u_max=bounds[1],
                                with_aux=True)


def solve_zero(outs, B):
    """Solve 0's outputs of a batch (Z, U, J, AUX; AUX's batch dim is 1)."""
    if B != 1:
        return outs
    return tuple(o[:, 0] if key == "AUX" else o[0]
                 for key, o in zip(("Z", "U", "J", "AUX"), outs))


def stateful_iteration(row, rng):
    """22d: one float32 iteration of a stateful row, its counts from zero:
    ``rollout`` (the aux recorded), ``local_model`` replaying the aux, K1
    (``traced_gains``' ladder of regs, one batched call), the kernel
    (``fused_control_law``: K2(g) or K2(e) over the traced inner step)
    with the cost (in K2(g) under IGNORE_UNCERTAINTY, else a post-pass)
    and the finite argmin of J. The ladder's reg is the first at which
    the plain version's float32 and float64 outputs (Z, U, J and the aux)
    agree within TRACED_CONDITION and the candidates move over the alphas
    (TRACED_SPREAD), judged on the ladder as one batch (``traced_path``'s
    rule), and, for K2(g)'s rows (``STATEFUL_F32_B64``), at which they
    agree so on 22b's B=64 batch around it too; its gains are 22b's
    inputs. Returns (problem, inputs or None, the B=64 batch, the plain
    versions on it, the float32 plain's ms, the iteration's record)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import (default_fit_alphas,
                                                 local_model, rollout)
    f32 = torch.float32
    model, cost, enc, bounds, z0, U0 = stateful_problem(row, "cuda", f32)
    a32 = default_fit_alphas(f32, "cuda")
    m64, c64, b64 = cast_up(model), cast_up(cost), _bounds64(bounds)
    problem = (model, cost, enc, bounds)
    t0 = time.perf_counter()
    reset_all_counts()
    Z, AUX = rollout(model, z0, U0, enc)
    derivs = local_model(Z, U0, AUX, model, cost, enc)
    regs, k, K = traced_gains(derivs, 0.0)
    record = {"regs": regs[:1] + regs[-1:], "reg": None}

    def plain(batch):
        p32, ms = timed_call(lambda: stateful_plain(model, cost, *batch, a32,
                                                    enc, bounds))
        p64 = stateful_plain(m64, c64, *(t.double() for t in batch),
                             a32.double(), enc, b64)
        return p32, p64, ms

    def own(p32, p64, j=slice(None)):
        """The largest relative distance of any output (solve ``j``'s,
        its batch dim 1 in the aux) and whether the float32 ones are
        finite."""
        dist, finite = 0.0, True
        for q, (a, b) in enumerate(zip(p32, p64)):
            a, b = (a[:, j], b[:, j]) if q == 3 else (a[j], b[j])
            dist = max(dist, rel_err(a.double(), b)[1])
            finite = finite and bool(torch.isfinite(a).all())
        return dist, finite

    lanes = []
    if regs:
        n = len(regs)
        ladder = (Z.expand((n,) + Z.shape).contiguous(),
                  U0.expand((n,) + U0.shape).contiguous(), k, K)
        q32, q64, _ = plain(ladder)
        for j in range(n):
            dist, finite = own(q32, q64, j)
            spread = rel_err(q64[1][j][:, 0], q64[1][j][:, -1])[1]
            if finite and dist <= TRACED_CONDITION \
                    and spread >= TRACED_SPREAD:
                lanes.append((j, dist, spread))
    record["tried"] = []
    for j, dist, spread in lanes[:4 if row in STATEFUL_F32_B64 else 1]:
        ins = (Z, U0, k[j].contiguous(), K[j].contiguous())
        batch = batch_of(rng, *ins, 64)
        for t, t1 in zip(batch, ins):
            t[0] = t1
        p32, p64, ms = plain(batch)
        batch_dist, finite = own(p32, p64)
        record["tried"].append({"reg": regs[j], "own_distance": dist,
                                "spread": spread,
                                "batch_own_distance": batch_dist})
        if row not in STATEFUL_F32_B64 or (
                finite and batch_dist <= TRACED_CONDITION):
            break
    else:
        return problem, None, None, None, None, None, record
    record.update(record["tried"][-1])
    out = stateful_call(model, cost, *ins, a32, enc, bounds)
    J = out[2]
    best = int(torch.argmin(torch.where(torch.isfinite(J), J, torch.inf)))
    torch.cuda.synchronize()
    record.update(launches=read_counts(), best=best,
                  iteration_s=time.perf_counter() - t0)
    return problem, ins, batch, p32, p64, ms, record


def raw_k2g(model, cost, Z, U, k, K, alphas, enc, bounds=(None, None)):
    """A closure launching K2(g) alone on preallocated outputs (one solve
    or a batch; the state's start and the aux buffers too)."""
    import torch
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    from pddp_tpu_torch.ops import traced_rollout as tro
    if Z.dim() == 2:
        Z, U, k, K = (t[None] for t in (Z, U, k, K))
    kc = cost if enc == StateEncoding.IGNORE_UNCERTAINTY else None
    tr = tro.traced(model, kc, enc, Z.dtype, "cuda", allow_stateful=True)
    B, N, A = U.shape[0], U.shape[1], alphas.shape[0]
    nz, nu = Z.shape[-1], U.shape[-1]
    p, w = tr.buffers(model, kc, Z.dtype, Z.device)
    bnd = fr._bounds(*bounds, nu, Z.dtype, Z.device)
    S0 = tro._state_rows(model, (B, A), Z.dtype, Z.device)
    outs = [torch.empty(s, dtype=Z.dtype, device=Z.device)
            for s in ((B, N + 1, A, nz), (B, N, A, nu), (B, A),
                      (B, N, A, max(1, tr.n_aux)))]
    fn = tro._function(tr, Z.dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        check(fn(*(t.data_ptr() for t in (Z, U, k, K, alphas, p, w)),
                 None if bnd is None else bnd.data_ptr(),
                 outs[0].data_ptr(), outs[1].data_ptr(),
                 outs[2].data_ptr() if tr.has_cost else None, B, N, A,
                 S0.data_ptr(), outs[3].data_ptr(), stream) == 0,
              "K2(g) launch")
    return launch


def raw_k2e_traced(model, Z, U, k, K, alphas, enc):
    """A closure launching K2(e) over the traced inner step alone on
    preallocated outputs."""
    import torch
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    if Z.dim() == 2:
        Z, U, k, K = (t[None] for t in (Z, U, k, K))
    B, N, A = U.shape[0], U.shape[1], alphas.shape[0]
    nz, nu, n, P = Z.shape[-1], U.shape[-1], model.state_size, \
        model.n_particles
    dtype = Z.dtype
    tr = fpr.inner_step(model.inner, dtype, "cuda")
    p, w = tr.buffers(model.inner, dtype, "cuda")
    eps = model.eps.to(dtype).contiguous()
    outs = [torch.empty(s, dtype=dtype, device="cuda")
            for s in ((B, N + 1, A, nz), (B, N, A, nu), (B, N, A, P, n))]
    fn = fpr._traced_function(tr, enc, dtype)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = ([t.data_ptr() for t in (Z, U, k, K, alphas, p, w, eps)]
            + [None] + [o.data_ptr() for o in outs]
            + [B, N, A, P, int(bool(model.infer_noise_variables)), stream])

    def launch():
        check(fn(*ptrs) == 0, "K2(e) traced launch")
    return launch


def k2g_work(tr, B, N, A, itemsize, bounded):
    """(bytes, operations) of one K2(g) call: K2(f)'s (``k2f_work``) and
    the state's start read once, each step's aux written once."""
    nbytes, ops = k2f_work(tr, B, N, A, itemsize, bounded)
    return nbytes + B * A * (tr.n_state + N * tr.n_aux) * itemsize, ops


def stateful_times(row, tr, model, cost, enc, bounds, ins, batch):
    """22e: the row's kernel alone at B=1 and 64 (float32, events over raw
    launches) beside its bound, the larger of the roofline and the chain
    floor: K2(g)'s ``k2f_chain_cycles`` of the traced stateful step (the
    feedback law, then the step to the next z and state), the traced
    K2(e)'s ``k2e_chain_cycles`` with the inner step's chain."""
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    import torch
    a32 = default_fit_alphas(torch.float32, "cuda")
    N = ins[1].shape[0]
    bounded = bounds[0] is not None
    if row.startswith("G"):
        raw1 = raw_k2g(model, cost, *ins, a32, enc, bounds)
        raw64 = raw_k2g(model, cost, *batch, a32, enc, bounds)
        cycles, chain = tr.chain(LATENCY["float32"], bounded)
        work1 = k2g_work(tr, 1, N, 10, 4, bounded)
        work64 = k2g_work(tr, 64, N, 10, 4, bounded)
    else:
        raw1 = raw_k2e_traced(model, *ins, a32, enc)
        raw64 = raw_k2e_traced(model, *batch, a32, enc)
        nz, P = ins[0].shape[-1], model.n_particles
        cycles = k2e_chain_cycles(None, int(enc), nz, P, "float32",
                                  inner=tr)
        chain = {"inner_step": tr.chain(LATENCY["float32"])}
        work1 = k2e_work(None, int(enc), 1, N, 10, P, 4, inner=tr)
        work64 = k2e_work(None, int(enc), 64, N, 10, P, 4, inner=tr)
    out = rest_row_times(raw1, raw64, work1, work64, cycles, N, "float32")
    out.update(chain_cycles=cycles, chain=chain)
    return out


def phase22b_rows(card, rng, build):
    """22b, 22d and 22e per stateful row at full width: the row's
    iteration (``stateful_iteration``: its kernel launched once, K1 at
    least once, no other K2), then its kernel against the plain version at
    the iteration's inputs, ten alphas, B=1 and B=64 (the gains perturbed
    per solve but for solve 0, the B=1 inputs): float64 (REST_TOL: Z, U
    and AUX 1e-10, J 1e-8, pddp_tpu's own for its stateful kernel, the
    float32 model and inputs cast up) and float32 (``rest_f32``: the float32
    plain version's own distance to float64 on the same inputs sets the
    tolerance, as in phases 19 and 21: the closed loop amplifies each
    step's rounding, so a fixed float32 tolerance would pass or fail with
    the gains; at B=64 for STATEFUL_F32_B64's rows, at B=1 for all);
    then the kernel alone beside its bound (22e)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    tm = traced_models()
    f32 = torch.float32
    rows, failed, inputs = [], [], {}
    for row in tm.STATEFUL_ROWS:
        t0 = time.perf_counter()
        kind, codec, cost_kind = tm.STATEFUL_ROWS[row]
        N = STATEFUL_H[row[0]]
        out = {"row": row, "model": kind, "codec": codec, "cost": cost_kind,
               "N": N, "A": 10,
               "P": STATEFUL_P if row.startswith("E") else None}
        ((model, cost, enc, bounds), ins, batch, plain32, ref,
         out["plain_ms_B64"], rec) = stateful_iteration(row, rng)
        out["iteration"] = rec
        if ins is None:
            failed.append("22b {}: no reg of the ladder gives gains that "
                          "move the candidates and that float32 computes "
                          "within {} of float64: {}".format(
                              row, TRACED_CONDITION, rec))
            emit({"phase": "22b", "card": card, **out})
            continue
        key = "K2(g)" if row.startswith("G") else "K2(e) traced"
        counts = rec["launches"]
        out["launches"] = counts[key]
        others = {k: v for k, v in counts.items()
                  if k.startswith("K2") and k != key and v}
        if counts[key] != 1 or counts["K1"] < 1 or others:
            failed.append("22d {}: the iteration launched {}".format(
                row, counts))
        a32 = default_fit_alphas(f32, "cuda")
        m64, c64, b64 = cast_up(model), cast_up(cost), _bounds64(bounds)
        inputs[row] = (model, cost, enc, bounds, ins,
                       solve_zero(ref, 1), solve_zero(plain32, 1))
        for B, xs in ((1, ins), (64, batch)):
            kern64 = stateful_call(m64, c64, *(t.double() for t in xs),
                                   a32.double(), enc, b64)
            errs = rest_errors(kern64, solve_zero(ref, B))
            kern32 = stateful_call(model, cost, *xs, a32, enc, bounds)
            hold = rest_f32(kern32, solve_zero(plain32, B),
                            solve_zero(ref, B))
            held = rest_f64_held(errs)
            checked = B == 1 or row in STATEFUL_F32_B64
            out["B{}".format(B)] = {"float64": errs, "float64_held": held,
                                    "float32": hold,
                                    "float32_checked": checked}
            if not held:
                failed.append("22b {} B={}: float64 off the plain version: "
                              "{}".format(row, B, errs))
            if checked and not all(v["held"] for v in hold.values()):
                failed.append("22b {} B={}: float32 past its derived "
                              "tolerance: {}".format(row, B, hold))
        out["max_abs_err"] = max(e[0] for e in
                                 out["B1"]["float64"].values())
        tr = build["stateful"][row, "float32"][1]
        out.update(stateful_times(row, tr, model, cost, enc, bounds, ins,
                                  batch))
        out["seconds"] = time.perf_counter() - t0
        emit({"phase": "22b", "card": card, **out})
        rows.append(out)
    return rows, failed, inputs


def phase22c_exact(card, rng, inputs):
    """22c: E1's traced K2(e) (a bare subclass of the cartpole) against
    the hand-written K2(e) on the exact cartpole, the same noise and
    inputs (22b's), in one call: float64 within REST_TOL of each other,
    float32 each held by ``rest_f32`` against E1's plain version (the
    same arithmetic on the same inputs); both timed alone at B=1 and 64
    in float32, in turns."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import default_fit_alphas
    from pddp_tpu_torch.examples.cartpole import CartpoleDynamicsModel
    from pddp_tpu_torch.ops import fused_particle_rollout as fpr
    from pddp_tpu_torch.ops._examples import example_of
    failed = []
    if "E1" not in inputs:  # failed in 22b
        return None, failed
    t0 = time.perf_counter()
    model, cost, enc, bounds, ins, ref, plain32 = inputs["E1"]
    inner = model.inner
    exact = model.replace(inner=CartpoleDynamicsModel(
        *(getattr(inner, n) for n in ("dt", "mc", "mp", "l", "mu", "g")),
        device="cuda", dtype=torch.float32))
    check(example_of(exact.inner)[0] is CartpoleDynamicsModel
          and example_of(inner)[0] is None,
          "22c: E1's inner model and the exact cartpole")
    a32 = default_fit_alphas(torch.float32, "cuda")
    out = {"row": "E1", "example": "cartpole_chol"}
    ins64 = tuple(t.double() for t in ins)
    b64 = _bounds64(bounds)
    f_64 = stateful_call(cast_up(model), cast_up(cost), *ins64,
                         a32.double(), enc, b64)
    before = fpr.launches["rollout"]
    h_64 = stateful_call(cast_up(exact), cast_up(cost), *ins64,
                         a32.double(), enc, b64)
    check(fpr.launches["rollout"] == before + 1,
          "22c: the exact cartpole ran the hand-written K2(e)")
    errs = rest_errors(f_64, h_64)
    out["float64"] = errs
    if not rest_f64_held(errs):
        failed.append("22c: traced K2(e) off the hand-written K2(e) in "
                      "float64: {}".format(errs))
    f_32 = stateful_call(model, cost, *ins, a32, enc, bounds)
    h_32 = stateful_call(exact, cost, *ins, a32, enc, bounds)
    out["float32"] = {"traced": rest_f32(f_32, plain32, ref),
                      "hand": rest_f32(h_32, plain32, ref),
                      "traced_vs_hand": rest_errors(f_32, h_32)}
    for name in ("traced", "hand"):
        if not all(v["held"] for v in out["float32"][name].values()):
            failed.append("22c: {} K2(e) float32 past its derived "
                          "tolerance: {}".format(name, out["float32"][name]))
    batch = batch_of(rng, *ins, 64)
    raws = {"traced": (raw_k2e_traced(model, *ins, a32, enc),
                       raw_k2e_traced(model, *batch, a32, enc)),
            "hand": (raw_k2e(exact, *ins, a32, enc),
                     raw_k2e(exact, *batch, a32, enc))}
    times = {k: {"ms": [], "ms_B64": []} for k in raws}
    for name in list(raws) + list(raws)[::-1]:
        times[name]["ms"].append(events_ms(raws[name][0], 20))
        times[name]["ms_B64"].append(events_ms(raws[name][1], 5))
    out["times"] = {k: {q: float(np.median(v)) for q, v in t.items()}
                    for k, t in times.items()}
    out["traced_over_hand"] = (out["times"]["traced"]["ms"]
                               / out["times"]["hand"]["ms"])
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "22c", "card": card, **out})
    return out, failed


def stateful_cpu_solve():
    """22d's float64 reference on the CPU: G1's solve (no bounds) through
    the plain versions."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    model, cost, enc, _, z0, U0 = stateful_problem("G1", "cpu",
                                                   torch.float64)
    return solve(model, cost, z0, U0, ILQROptions(**STATEFUL_SOLVE_OPTS),
                 encoding=enc)


def phase22d_solve(card, cpu):
    """22d: G1's ``solve(riccati_mode="kernel", fused_rollout=True)`` in
    float64 (no bounds), its counts from zero: K1 launched once an
    evaluation, K2 none (a stateful model's line search stays on the scan
    in ``solve``, as in pddp_tpu's), its ends and J as the CPU's plain
    solve's (TRACED_J_RTOL)."""
    import torch
    from pddp_tpu_torch.controllers.ilqr import ILQROptions, solve
    failed = []
    model, cost, enc, _, z0, U0 = stateful_problem("G1", "cuda",
                                                   torch.float64)
    reset_all_counts()
    r, sec = _timed(lambda: solve(model, cost, z0, U0, ILQROptions(
        **STATEFUL_SOLVE_OPTS, riccati_mode="kernel", fused_rollout=True),
        encoding=enc))
    counts = read_counts()
    out = {"row": "G1", **_ends(r), "wall_s": sec, "launches": counts,
           "cpu": _ends(cpu), "J_rel": abs(r.J_opt - cpu.J_opt)
           / abs(cpu.J_opt)}
    if not (counts["K1"] == r.evals > 0 and not any(
            v for k, v in counts.items() if k.startswith("K2"))):
        failed.append("22d G1 solve: launches {} for {} evaluations".format(
            counts, r.evals))
    if not ((r.state, r.iterations, r.evals)
            == (cpu.state, cpu.iterations, cpu.evals)
            and out["J_rel"] <= TRACED_J_RTOL):
        failed.append("22d G1 solve: the card's float64 solve differs from "
                      "the CPU's: {}".format(out))
    emit({"phase": "22d", "card": card, **out})
    return out, failed


def phase22_stateful(card, build, cpu):
    """Phase 22, K2(g) and K2(e) over a traced inner step on the card: 22a
    the libraries' build, 22b each row's iteration (22d), its kernel
    against the plain version and (22e) its times and bound, 22c E1
    against the hand-written K2(e), 22d G1's solve."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(2222)
    a = phase22a_build(card, build)
    b, failed, inputs = phase22b_rows(card, rng, build[0])
    c, more = phase22c_exact(card, rng, inputs)
    failed += more
    d, more = phase22d_solve(card, cpu)
    failed += more
    emit({"phase": 22, "seconds": time.perf_counter() - t0,
          "failed": failed})
    check(not failed, "phase 22: {}".format(failed))
    return {"build": a, "rows": b, "exact": c, "solve": d}


def stateful_kernel_rows(stateful):
    """The kernels line's K2(g) and traced K2(e) rows (phase 22): each
    row's launches those of its iteration (22d), its error that of float64
    at B=1 against the plain version, its times float32 (22e); E1 also
    the hand-written K2(e)'s times on the exact cartpole (22c), G1 its
    solve's launches (K1 an evaluation; K2(g) none, the scan)."""
    kernels = []
    for row in stateful["rows"]:
        g = row["row"].startswith("G")
        k = {"name": "{} {} {} {} {}".format(
                 "K2(g) traced_rollout" if g else "K2(e) traced inner",
                 row["row"], row["model"], row["codec"].lower(),
                 row["cost"]),
             "route": "cuda",
             "source": "pddp_tpu_torch/csrc/{}".format(
                 "traced_rollout.cuh" if g else "fused_particle_rollout.cuh"),
             "replaces": "pddp_tpu/ops/fused_rollout.py:114",
             "launches": row["launches"],
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms_B64"], "plain_B": 64,
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "bound_note": "chain" if row["chain_floor_ms"]
             >= row["roofline_ms"] else "roofline",
             "library_ms": None, "ms_B64": row["ms_B64"],
             "bound_ms_B64": row["bound_ms_B64"], "N": row["N"],
             "codec": row["codec"], "chain_cycles": row["chain_cycles"]}
        if row["row"] == "E1" and stateful["exact"] is not None:
            k["exact_example"] = stateful["exact"]["times"]
        if row["row"] == "G1":
            k["solve_launches"] = stateful["solve"]["launches"]
        kernels.append(k)
    return kernels


def traced_kernel_rows(traced):
    """The kernels line's K2(f) rows (phase 21): each row's launches those
    of its path run (21b: a float32 solve through K1 and K2(f)), its error
    that of float64 at B=1 against the plain version, its times float32
    (21e); R5-R8 also K2(f) and the hand-written stage on the exact
    example (21c), R5 and R1 the solves' launches (21d)."""
    kernels = []
    exact = {r["row"]: r for r in traced["exact"]}
    solves = traced["solves"]
    for row in traced["rows"]:
        k = {"name": "K2(f) traced_rollout {} {} {} {}".format(
                 row["row"], row["model"], row["codec"].lower(),
                 row["cost"]),
             "route": "cuda",
             "source": "pddp_tpu_torch/csrc/traced_rollout.cuh",
             "replaces": "pddp_tpu/ops/fused_rollout.py:114",
             "launches": row["launches"],
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms_B64"], "plain_B": 64,
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "bound_note": "chain" if row["chain_floor_ms"]
             >= row["roofline_ms"] else "roofline",
             "library_ms": None, "ms_B64": row["ms_B64"],
             "bound_ms_B64": row["bound_ms_B64"], "N": row["N"],
             "codec": row["codec"], "chain_cycles": row["chain_cycles"]}
        if row["row"] in exact:
            k["exact_example"] = exact[row["row"]]["times"]
        if row["row"] == "R5":
            k["golden_solve_launches"] = solves["golden"]["launches"][
                "K2(f)"]
        if row["row"] == "R1":
            k["quadrotor_solve_launches"] = solves["quadrotor"][
                "float32"]["launches"]["K2(f)"]
            k["batch_launches"] = solves["batch"]["launches"]["K2(f)"]
        kernels.append(k)
    return kernels


def phase6_kernels(res, bnn, bnn_model_, paths, times, entry, pddp,
                   batched, particles, multi, rest, bf16, traced, stateful):
    """The kernels line: every kernel with its path's launches, its error
    against its plain version, its times and its bound. K1 and K2(a) are
    read on the slice-1 path (phase 5), K2(d) and its fragment entries on
    the BNN iteration (phase 8), where K2(d) runs F1-F3's device functions
    inline and the entries themselves launch no time, K2(b) on the double
    cartpole's path and K2(c) on the pendulum's under the Cholesky codec
    (phase 12; the other paths' numbers ride along under "paths"). The
    latency-chain kernels K1 and K2(a)-(d) take their bounds, the larger of
    the roofline and the chain floor, and their times at 64 solves from
    phase 13 (K2(d) also its cluster size and threads a CTA). K1's block
    kernel is read on the entry point (phase 14: its launches and its
    error at the fitted models) and timed at rendezvous under the
    Cholesky codec (nz = 44) in phase 13, its other widths under
    "shapes". K1 at the BNN's shape (nz = 14) and K2(d) also carry their
    launches in the PDDP trial (phase 15b's loop, none: it runs the scan,
    as pddp_tpu's does) and in the checks on the model it trained."""
    kernels = [
        {"name": "K1 riccati_backward", "route": "cuda",
         "source": "pddp_tpu_torch/csrc/backward_kernel.cu",
         "replaces": "pddp_tpu/ops/backward_kernel.py:45",
         "launches": res["main_path_launches"]["K1"],
         "max_abs_err": res["max_abs_err"]["K1"], "ms": res["K1_ms"],
         "wrapper_ms": res["K1_wrapper_ms"],
         "plain_ms": res["K1_plain_ms"], "library_ms": None},
        {"name": "K2(a) fused_rollout_cartpole", "route": "cuda",
         "source": "pddp_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "pddp_tpu/ops/fused_rollout.py:114",
         "launches": res["main_path_launches"]["K2"],
         "max_abs_err": res["max_abs_err"]["K2"], "ms": res["K2_ms"],
         "wrapper_ms": res["K2_wrapper_ms"],
         "plain_ms": res["K2_plain_ms"], "library_ms": None},
    ]
    src = "pddp_tpu_torch/csrc/fused_bnn_rollout.cu"
    work = bnn_work(bnn_model_, 1, bnn["N"], bnn["A"], bnn["A"], 4)
    rows = [
        ("K2(d)", "K2(d) fused_bnn_rollout",
         "pddp_tpu/ops/fused_rollout.py:114", None),
        ("F1", "F1 bnn_infer_eps",
         "scripts/probe_micro.py:57 (also probe_micro2.py:46, "
         "probe_micro3.py:47)", bnn["F1_library_ms"]),
        ("F2", "F2 bnn_moment_match",
         "scripts/probe_micro4.py:83 (also probe_micro5.py:90)", None),
        ("F3", "F3 bnn_mlp", "scripts/probe_kernel_mlp_batch.py:86", None),
    ]
    for key, name, replaces, library in rows:
        bound, by = bound_ms(*work[key], "float32")
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": bnn["path_launches"][key],
               "max_abs_err": bnn["max_abs_err"][key],
               "ms": bnn[key + "_ms"], "plain_ms": bnn[key + "_plain_ms"],
               "bound_ms": bound, "bound_by": by, "library_ms": library}
        if key == "K2(d)":
            row["wrapper_ms"] = bnn["K2(d)_wrapper_ms"]
            row["also_replaces"] = "scripts/probe_fused_stateful.py:66"
        kernels.append(row)
    for st, label in (("b", "double_cartpole"), ("c", "pendulum_chol")):
        p = paths[label]
        kernels.append({
            "name": "K2({}) fused_rollout {}".format(st, label),
            "route": "cuda", "source": "pddp_tpu_torch/csrc/fused_rollout.cu",
            "replaces": "pddp_tpu/ops/fused_rollout.py:114",
            "launches": p["main_path_launches"]["K2(" + st + ")"],
            "max_abs_err": p["max_abs_err"]["K2"], "ms": p["K2_ms"],
            "wrapper_ms": p["K2_wrapper_ms"], "plain_ms": p["K2_plain_ms"],
            "library_ms": None,
            "paths": {k: {"stage": v["K2_stage"], "ms": v["K2_ms"],
                          "plain_ms": v["K2_plain_ms"],
                          "bound_ms": v["K2_bound_ms"],
                          "launches": v["main_path_launches"],
                          "K1_ms": v["K1_ms"],
                          "K1_plain_ms": v["K1_plain_ms"],
                          "K1_bound_ms": v["K1_bound_ms"]}
                      for k, v in paths.items()}})

    def timed(kernel, path):
        rows = {r["B"]: r for r in times
                if r["kernel"] == kernel and r["path"] == path}
        one = rows[1]
        out = {"bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
               "bound_note": "chain" if one["chain_floor_ms"]
               >= one["roofline_ms"] else "roofline",
               "ms_B64": rows[64]["ms"],
               "bound_ms_B64": rows[64]["bound_ms"]}
        if "plan" in one:   # K2(d): its cluster launch
            out.update(cluster=one["plan"]["cluster"],
                       threads_per_cta=one["plan"]["threads"],
                       particles_per_cta=one["plan"]["particles_per_cta"],
                       cluster_B64=rows[64]["plan"]["cluster"],
                       threads_per_cta_B64=rows[64]["plan"]["threads"])
        return out
    for row, kernel, path in ((kernels[0], "K1", "cartpole"),
                              (kernels[1], "K2(a)", "cartpole"),
                              (kernels[2], "K2(d)", "bnn"),
                              (kernels[-2], "K2(b)", "double_cartpole"),
                              (kernels[-1], "K2(c)", "pendulum_chol")):
        row.update(timed(kernel, path))
    block = {(r["path"], r["B"]): r for r in times
             if r["kernel"] == "K1 block"}
    head = block[("rendezvous_chol", 1)]
    kernels.append({
        "name": "K1 riccati_backward_block", "route": "cuda",
        "source": "pddp_tpu_torch/csrc/backward_kernel.cu",
        "replaces": "pddp_tpu/ops/backward_kernel.py:45",
        "launches": entry["launches"]["K1_block"],
        "max_abs_err": entry["K1_block_max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "bound_note": "chain" if head["chain_floor_ms"]
        >= head["roofline_ms"] else "roofline",
        "library_ms": None,
        "ms_B64": block[("rendezvous_chol", 64)]["ms"],
        "bound_ms_B64": block[("rendezvous_chol", 64)]["bound_ms"],
        "cluster": head["plan"]["cluster"], "tile": head["plan"]["tile"],
        "threads": head["plan"]["threads"],
        "shapes": {label: {"nz": r["nz"], "nu": r["nu"], "ms": r["ms"],
                           "ms_B64": block[(label, 64)]["ms"],
                           "plain_ms": r["plain_ms"],
                           "bound_ms": r["bound_ms"],
                           "bound_by": r["bound_by"],
                           "plan": r["plan"],
                           "plan_B64": block[(label, 64)]["plan"]}
                   for (label, B), r in block.items() if B == 1}})
    # The PDDP loop (phase 15b): its own launches and its checks'.
    b15 = pddp["b"]
    k1_bnn = next(r for r in times if r["kernel"] == "K1"
                  and r["path"] == "bnn" and r["B"] == 1)
    kernels[0]["bnn_nz14"] = {
        "ms": k1_bnn["ms"], "plain_ms": k1_bnn["plain_ms"],
        "bound_ms": k1_bnn["bound_ms"],
        "pddp_trial_launches": b15["loop_launches"]["K1"],
        "trained_model_launches": b15["trained_model"]["launches"]["K1"]}
    kernels[2].update(
        pddp_trial_launches=b15["loop_launches"]["K2(d)"],
        trained_model_launches=b15["trained_model"]["launches"]["K2(d)"])
    # The warp kernel's nu = 4 instances.
    kernels[0]["nu4"] = {"{}_B{}".format(r["path"], r["B"]): {
        "nz": r["nz"], "ms": r["ms"], "bound_ms": r["bound_ms"],
        "plain_ms": r.get("plain_ms")}
        for r in times if r["kernel"] == "K1 warp"}
    # The batched solves (phase 16): K1 with a reg per lane and K2(a) at
    # bench.py's B=1024 cartpole batch, K1 at one BNN chunk (B=256,
    # nz=14); launches per batched solve (16a(ii)) or chunk (16b).
    sources = {"K1": ("pddp_tpu_torch/csrc/backward_kernel.cu",
                      "pddp_tpu/ops/backward_kernel.py:45",
                      "K1 riccati_backward"),
               "K2(a)": ("pddp_tpu_torch/csrc/fused_rollout.cu",
                         "pddp_tpu/ops/fused_rollout.py:114",
                         "K2(a) fused_rollout_cartpole")}
    for row in batched["a"]["kernel_rows"] + batched["b"]["kernel_rows"]:
        src, replaces, name = sources[row["kernel"]]
        kernels.append({
            "name": "{} batched {} B={}".format(name, row["path"], row["B"]),
            "route": "cuda", "source": src, "replaces": replaces,
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_note": "chain" if row["chain_floor_ms"]
            >= row["roofline_ms"] else "roofline",
            "library_ms": None, "B": row["B"], "N": row["N"],
            "nz": row["nz"] if "nz" in row else 4})
    # The particle model (phase 17): K1 at each row's shape, its launches
    # those of the row's float32 solve.
    for row in particles["rows"]:
        k1 = row["K1"]
        kernels.append({
            "name": "K1 riccati_backward{} particles {}".format(
                "_block" if k1["kernel"] == "K1 block" else "", row["path"]),
            "route": "cuda",
            "source": "pddp_tpu_torch/csrc/backward_kernel.cu",
            "replaces": "pddp_tpu/ops/backward_kernel.py:45",
            "launches": k1["launches"], "max_abs_err": k1["max_abs_err"],
            "ms": k1["ms"], "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "bound_note": "chain" if k1["chain_floor_ms"]
            >= k1["roofline_ms"] else "roofline",
            "library_ms": None, "B": 1, "N": k1["N"], "nz": k1["nz"],
            "nu": k1["nu"], "P": row["P"]})
    # Multi-GPU (phase 18): K1 and K2(a) at a rank's block of the sharded
    # batch, K1 at the particle-sharded BNN solve; launches a rank of the
    # 2-rank gloo world (those of the 1-rank NCCL world beside them).
    nccl = multi["nccl_1rank"]["launches"][0]
    for row in multi["kernel_rows"]:
        src, replaces, name = sources[row["kernel"]]
        path = "psolve_float32" if row["path"].startswith("bnn") else "batch"
        kernels.append({
            "name": "{} sharded {}".format(name, row["path"]),
            "route": "cuda", "source": src, "replaces": replaces,
            "launches": row["launches"],
            "launches_nccl_1rank": nccl[path][row["kernel"]],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bound_note": "chain" if row["chain_floor_ms"]
            >= row["roofline_ms"] else "roofline",
            "library_ms": None, "B": row["B"], "N": row["N"],
            "nz": row.get("nz", 4)})
    # The rest of K2's gate (phase 19): K2(e) on phase 17's rows, K2(d)
    # under four more codecs, K2(a)-(c) on constrain_model's examples; the
    # launches of each row's float32 iteration or solve, the errors of
    # float64, the times of float32 alone at B=1 and 64.
    specs = (
        ("particles", "K2(e) fused_particle_rollout {}",
         "pddp_tpu_torch/csrc/fused_particle_rollout.cu"),
        ("bnn", "K2(d) fused_bnn_rollout {}",
         "pddp_tpu_torch/csrc/fused_bnn_rollout.cu"),
        ("constrained", "K2({stage}) fused_rollout {}",
         "pddp_tpu_torch/csrc/fused_rollout.cu"))
    for key, name, src in specs:
        for row in rest[key]:
            kernels.append({
                "name": name.format(row["path"], stage=row.get("stage")),
                "route": "cuda", "source": src,
                "replaces": "pddp_tpu/ops/fused_rollout.py:114",
                "launches": row["launches"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bound_note": "chain" if row["chain_floor_ms"]
                >= row["roofline_ms"] else "roofline",
                "library_ms": None, "ms_B64": row["ms_B64"],
                "bound_ms_B64": row["bound_ms_B64"], "N": row.get(
                    "N", row.get("H")), "codec": row["codec"]})
    # The bfloat16 knobs (phase 20): K2(d)'s and F3's float32 instances on
    # the tensor cores, timed in float32 (20a, 20b), their errors those of
    # float64 against the plain version; K2(d)'s launches under the
    # Cholesky codec those of 20c's iteration (the path), under the other
    # codecs 20b's; F3 runs inline in K2(d) and launches no time there.
    src = "pddp_tpu_torch/csrc/fused_bnn_rollout.cu"
    path = {r["knob"]: r["launches"] for r in bf16["iteration"]}
    for knob in BF16_KNOBS:
        f3 = {r["dtype"]: r for r in bf16["f3"] if r["knob"] == knob}
        kernels.append({
            "name": "F3 bnn_mlp bf16 {}".format(knob), "route": "cuda",
            "source": src,
            "replaces": "scripts/probe_kernel_mlp_batch.py:86",
            "launches": 0,
            "max_abs_err": f3["float64"]["abs_err"],
            "ms": f3["float32"]["ms"], "plain_ms": f3["float32"]["plain_ms"],
            "bound_ms": f3["float32"]["bound_ms"],
            "bound_by": f3["float32"]["bound_by"], "library_ms": None,
            "G": 10, "P": 100})
        for codec in BF16_CODECS:
            rows = {r["dtype"]: r for r in bf16["k2d"]
                    if r["knob"] == knob and r["codec"] == codec}
            one = rows["float32"]
            chol = codec == "UPPER_TRIANGULAR_CHOLESKY"
            kernels.append({
                "name": "K2(d) fused_bnn_rollout bf16 {} {}".format(
                    knob, codec.lower()),
                "route": "cuda", "source": src,
                "replaces": "pddp_tpu/ops/fused_rollout.py:114",
                "launches": path[knob]["K2(d)"] if chol
                else one["launches"],
                "max_abs_err": rows["float64"]["max_abs_err"],
                "ms": one["ms"], "plain_ms": one["plain_ms"],
                "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
                "bound_note": "chain" if one["chain_floor_ms"]
                >= one["roofline_ms"] else "roofline",
                "library_ms": None, "ms_B64": one["ms_B64"],
                "bound_ms_B64": one["bound_ms_B64"],
                "full_precision_ms": one.get("full_precision_ms"),
                "full_precision_ms_B64": one.get("full_precision_ms_B64"),
                "cluster": one["plan"]["cluster"],
                "threads_per_cta": one["plan"]["threads"],
                "N": one["N"], "codec": codec})
    kernels += traced_kernel_rows(traced)
    kernels += stateful_kernel_rows(stateful)
    return {"kernels": kernels}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # Full float32 everywhere: no TF32 in matrix products or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import pddp_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    try:
        return _run_phases(card, run, seconds, t_start)
    except BaseException:
        # Where the time went, also when a phase failed.
        emit({"phase_seconds": seconds})
        raise


def _run_phases(card, run, seconds, t_start):
    # The CPU's side of the float64 checks of phases 14 and 16 runs beside
    # the build; "0_cpu" is the wait for it after the build.
    # Phase 21's and 22's traces are taken beside phase 0's build and
    # their libraries built after it at a low priority (21a and 22a
    # report them).
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cpu_refs = pool.submit(cpu_references)
        built = threading.Event()
        traced_build = pool.submit(traced_builds, built)
        try:
            run("0", phase0_build, card)
        finally:
            built.set()
        cpu_refs = run("0_cpu", cpu_refs.result)
        return _run_card_phases(card, run, seconds, t_start, cpu_refs,
                                traced_build)


def _run_card_phases(card, run, seconds, t_start, cpu_refs, traced_build):
    import torch
    run("1", phase1_k1)
    run("2", phase2_k2)
    run("3", phase3_golden_f64)
    run("4", phase4_golden_f32)
    res, main_inputs = run("5", phase5_main_path, card)
    run("7", phase7_bnn_kernels)
    bnn, bnn_model_, bnn_k1 = run("8", phase8_bnn_iteration, card)
    run("9", phase9_bnn_solve, card)
    run("10", phase10_k2bc)
    run("11", phase11_golden_cases)
    paths, path_inputs = run("12", phase12_example_paths, card)
    times = run("13", phase13_kernel_times, card,
                {"cartpole": main_inputs, **path_inputs}, bnn_k1)
    entry = run("14", phase14_entry_point, card, cpu_refs["entry"])
    pddp = run("15", phase15_pddp, card)
    batched = run("16", phase16_batched, card, cpu_refs)
    particles = run("17", phase17_particles, card, cpu_refs["particles"])
    multi = run("18", phase18_multi_gpu, card)
    rest = run("19", phase19_rest_of_k2, card, particles,
               cpu_refs["constrained"])
    bf16 = run("20", phase20_bf16, card)
    traced_build = run("21_build_wait", traced_build.result)
    traced = run("21", phase21_traced, card, traced_build,
                 cpu_refs["traced"])
    stateful = run("22", phase22_stateful, card, traced_build,
                   cpu_refs["stateful"])
    kernels = phase6_kernels(res, bnn, bnn_model_, paths, times, entry,
                             pddp, batched, particles, multi, rest, bf16,
                             traced, stateful)
    emit({"phase_seconds": seconds})
    emit({"total_s": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
