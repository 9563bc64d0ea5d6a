#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``pddp_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``pddp_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, solves the golden cartpole
problem through them in float64 and float32 against
``tests/golden/solver_trajectories.npz``, and times the main path (the
known-dynamics cartpole iLQR solve, horizon 200, ten step sizes) through
the kernels and through the plain versions. Each phase prints one JSON
line; any failure raises and exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result. It imports neither JAX nor ``pddp_tpu``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
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
    took the most device time (names cut to 90 characters)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    """A closure launching K1 alone on preallocated outputs (no checks, no
    finiteness reduction), for the kernel's own device time."""
    import torch
    from pddp_tpu_torch.ops import backward_kernel as bk
    ins = derivs[1:3] + derivs[4:]
    N, nz, nu = ins[1].shape
    k = torch.empty((1, N, nu), dtype=ins[0].dtype, device=ins[0].device)
    K = torch.empty((1, N, nu, nz), dtype=ins[0].dtype,
                    device=ins[0].device)
    fn = bk._function(ins[0].dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        check(fn(*(t.data_ptr() for t in ins), float(reg), k.data_ptr(),
                 K.data_ptr(), 1, N, nz, nu, stream) == 0, "K1 launch")
    return launch


def raw_k2(model, cost, Z, U, k, K, alphas):
    """A closure launching K2 alone on preallocated outputs."""
    import torch
    from pddp_tpu_torch.ops import fused_rollout as fr
    N, A = U.shape[0], alphas.shape[0]
    params = fr.param_buffer(model, cost, Z.dtype, Z.device)
    outs = [torch.empty(s, dtype=Z.dtype, device=Z.device)
            for s in ((1, N + 1, A, 4), (1, N, A, 1), (1, A))]
    fn = fr._function(Z.dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        check(fn(*(t.data_ptr() for t in (Z, U, k, K, alphas, params)),
                 None, *(o.data_ptr() for o in outs), 1, N, A, stream) == 0,
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


def k2_work(B, N, A, itemsize, bounded):
    """(bytes, operations) of one K2 call at nz=4, nu=1."""
    nz = 4
    n_in = B * ((N + 1) * nz + N + N + N * nz) + A + 63 + (2 if bounded
                                                          else 0)
    n_out = B * ((N + 1) * A * nz + N * A + A)
    stage_cost = 2 + 5 + 60 + 2          # sin/cos, d, d^T Q d, add
    step = ((3 * nz + 3) + (2 if bounded else 0) + stage_cost + 3
            + 40)                        # feedback, clamp, cost, R, model
    return ((n_in + n_out) * itemsize,
            B * A * (N * step + stage_cost))


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def k1_inputs(rng, B, N, nz, nu, dtype, device, indefinite=False):
    """Seeded Riccati inputs with a PSD joint Hessian of (z, u) per step
    (so L_zz and L_uu are PSD); ``indefinite`` shifts L_uu of the last
    three steps down by 2 I, so that Q_uu goes negative there and the
    eigen clamp acts (shifting every step drives V_zz indefinite and the
    recursion to overflow)."""
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
        L_uu[:, -3:] -= 2.0 * np.eye(nu)
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
    kernels = {}
    for name, r in report.items():
        rows, entry = [], None
        for line in r["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                smem = re.search(r"(\d+) bytes smem", line)
                rows.append({"entry": entry, "registers": int(m.group(1)),
                             "smem_bytes": int(smem.group(1)) if smem
                             else 0})
                entry = None
        kernels[name] = rows
    emit({"phase": 0, "card": card, "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(next(iter(report.values()))["seconds"], 3),
          "ptxas": kernels})


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
    rows = []
    for seed, (B, N, nz, nu, indefinite, reg) in enumerate(cases):
        for dtype in (torch.float32, torch.float64):
            ins = k1_inputs(np.random.default_rng(seed), B, N, nz, nu, dtype,
                            "cuda", indefinite)
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
            rows.append(row)
    emit({"phase": 1, "kernel": "K1", "cases": rows})
    for row in rows:
        check(row["finite"], "K1 case gave non-finite gains: {}".format(row))
        check(row["k_rel"] <= row["tol"] and row["K_rel"] <= row["tol"],
              "K1 disagrees with its plain version: {}".format(row))
        check(row.get("Q_uu_min_eig_last_step", -1.0) < 0,
              "the clamp case has a positive definite Q_uu: {}".format(row))


def phase2_k2():
    import torch
    from pddp_tpu_torch.controllers.ilqr import control_law
    from pddp_tpu_torch.encoding import StateEncoding
    from pddp_tpu_torch.ops import fused_rollout as fr
    enc = StateEncoding.IGNORE_UNCERTAINTY
    rows = []
    for seed, B in enumerate((1, 1024)):
        for dtype in (torch.float32, torch.float64):
            model, cost, Z, U, k, K = k2_inputs(np.random.default_rng(seed),
                                                B, 200, dtype, "cuda")
            alphas = torch.as_tensor(1.025**(-np.arange(10.0)**2),
                                     dtype=dtype, device="cuda")
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
                row = {"B": B, "N": 200, "A": 10, "dtype": dname,
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
    n1, n2 = bk.launches, fr.launches
    t0 = time.perf_counter()
    r = solve(model, cost, z0, U0, opts,
              encoding=StateEncoding.IGNORE_UNCERTAINTY)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return r, bk.launches - n1, fr.launches - n2, seconds


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
    bk.launches = fr.launches = 0
    ms_first, r_main = full_solve(True)
    counts = {"K1": bk.launches, "K2": fr.launches}
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

    # End-to-end metrics, kernels and plain versions in alternating turns.
    turns = {"kernels": {"iteration_ms": [], "full_solve_ms": [ms_first]},
             "plain": {"iteration_ms": [], "full_solve_ms": []}}
    evals = {"kernels": r_main.evals}
    for kernels in (True, False, False, True):
        key = "kernels" if kernels else "plain"
        turns[key]["iteration_ms"].append(
            events_ms(lambda: iteration(kernels), 50, warmup=5))
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
    return res, derivs


def phase6_kernels(res, derivs):
    B, N1, nz = 1, derivs[4].shape[0], derivs[4].shape[1]
    N, nu = N1 - 1, derivs[5].shape[-1]
    b1, f1 = k1_work(B, N, nz, nu, 4, sweeps=5)
    b2, f2 = k2_work(B, N, 10, 4, bounded=False)
    bound1, by1 = bound_ms(b1, f1, "float32")
    bound2, by2 = bound_ms(b2, f2, "float32")
    kernels = [
        {"name": "K1 riccati_backward", "route": "cuda",
         "source": "pddp_tpu_torch/csrc/backward_kernel.cu",
         "replaces": "pddp_tpu/ops/backward_kernel.py:45",
         "launches": res["main_path_launches"]["K1"],
         "max_abs_err": res["max_abs_err"]["K1"], "ms": res["K1_ms"],
         "wrapper_ms": res["K1_wrapper_ms"],
         "plain_ms": res["K1_plain_ms"], "bound_ms": bound1,
         "bound_by": by1, "library_ms": None},
        {"name": "K2 fused_rollout_cartpole", "route": "cuda",
         "source": "pddp_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "pddp_tpu/ops/fused_rollout.py:114",
         "launches": res["main_path_launches"]["K2"],
         "max_abs_err": res["max_abs_err"]["K2"], "ms": res["K2_ms"],
         "wrapper_ms": res["K2_wrapper_ms"],
         "plain_ms": res["K2_plain_ms"], "bound_ms": bound2,
         "bound_by": by2, "library_ms": None},
    ]
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

    card = card_line()
    print(card, flush=True)
    phase0_build(card)
    phase1_k1()
    phase2_k2()
    phase3_golden_f64()
    phase4_golden_f32()
    res, derivs = phase5_main_path(card)
    kernels = phase6_kernels(res, derivs)
    print(card_line(), flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
