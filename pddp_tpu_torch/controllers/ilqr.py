"""Iterative Linear Quadratic Regulator (port of
``pddp_tpu/controllers/ilqr.py``).

The functional core: rollout, local quadratic model, Riccati backward,
batched-alpha line search and the accept/retry solve loop. JAX's
``lax.scan``s are Python loops over the horizon, its ``lax.while_loop``s
are Python loops with the same status machine, and ``vmap`` over the
line-search candidates is an explicit candidate axis. Every function
takes leading batch dims before the time axis (``Z (..., N+1, nz)``), so
a batch of solves shares one call.

``solve`` can route the backward through K1 (``riccati_mode="kernel"``,
``ops/backward_kernel.py``) and the line search through K2
(``fused_rollout=True``, ``ops/fused_rollout.py``); on CPU tensors those
wrappers run the plain versions below. ``solve_lanes`` runs a batch of
independent solves as lanes of one loop (``parallel.batched_solve``).
``iLQRController`` is the stateful entry point over ``solve``: fit, a
warm step, the feedback law and MPC.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import IntEnum
from typing import Any, Optional

import numpy as np
import torch

from ..encoding import StateEncoding, decode_mean
from ..utils.constraint import boxqp, chol_solve, clamp
from ..utils.evaluation import (_tree_map, eval_cost, linearize_dynamics,
                                quadratize_cost)
from ..utils.linalg import SMALL_EIGH_N, _cholesky_upper, small_eigh
from .base import Controller

__all__ = [
    "iLQRController",
    "iLQRState",
    "ILQROptions",
    "ILQRResult",
    "rollout",
    "local_model",
    "forward",
    "linear_control_law",
    "Q",
    "backward",
    "control_law",
    "trajectory_cost",
    "solve",
    "step_once",
    "default_fit_alphas",
    "default_step_alphas",
]


class iLQRState(IntEnum):
    """iLQR optimization step state."""

    UNDEFINED = 0
    ACCEPTED = 1
    REJECTED = 2
    NOT_PD = 3
    MAX_REG = 4
    CONVERGED = 5

    def should_retry(self):
        return self in (iLQRState.UNDEFINED, iLQRState.NOT_PD,
                        iLQRState.REJECTED)

    def is_terminal(self):
        return self in (iLQRState.CONVERGED, iLQRState.MAX_REG)


def default_fit_alphas(dtype=torch.float32, device=None):
    """Backtracking schedule used by fit: 1.025^(-i^2), i = 0..9."""
    i = np.arange(10.0)
    return torch.as_tensor(1.025**(-i**2), dtype=dtype, device=device)


def default_step_alphas(dtype=torch.float32, device=None):
    """Backtracking schedule used by bare step/MPC calls."""
    return torch.as_tensor(10.0**np.linspace(0.0, -3.0, 11), dtype=dtype,
                           device=device)


@dataclass(frozen=True)
class ILQROptions:
    """Solver options (``pddp_tpu``'s fields and defaults).

    ``riccati_mode`` is "scan" (the Python-loop ``backward``),
    "parallel" (the associative scan of ``ops.riccati``) or "kernel" (K1).
    As in ``pddp_tpu``, constrained solves (``u_min`` and ``u_max``) and
    ``v_zz_reg`` take the scan whatever the mode, and so do action sizes
    past ``SMALL_EIGH_N`` (4) in kernel mode. ``fused_rollout`` runs the
    line search in K2 where ``ops.fused_rollout.supports_fused_rollout``
    admits the model.
    """

    n_iterations: int = 50
    tol: float = 5e-6
    max_reg: float = 1e10
    mu_min: float = 1e-6
    delta_0: float = 2.0
    alphas: Optional[Any] = None
    u_min: Optional[Any] = None
    u_max: Optional[Any] = None
    max_evals: int = 200
    v_zz_reg: bool = False
    approximate_hessians: bool = False
    riccati_mode: str = "scan"
    fused_rollout: bool = False
    cost_in_scan: bool = False


@dataclass
class ILQRResult:
    """Solution and warm-start state of one solve (of ``solve_lanes``: each
    field a tensor with a leading lane axis, ``state`` the codes)."""

    Z: torch.Tensor          # (N+1, nz) encoded state path
    U: torch.Tensor          # (N, nu) action path
    K: torch.Tensor          # (N, nu, nz) feedback gains
    J_opt: float             # cost
    state: iLQRState
    mu: float
    delta: float
    iterations: int          # accepted iterations
    evals: int               # backward + line-search evaluations


def _mv(A, x):
    """Batched matrix-vector product: (..., m, n) x (..., n) -> (..., m)."""
    return (A @ x[..., None])[..., 0]


def _T(A):
    return A.transpose(-1, -2)


def _stack_tree(trees, dim):
    """Stacks a list of equally-shaped aux nests along ``dim``."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_tree([t[j] for t in trees], dim)
                           for j in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees], dim) for k in first}
    return torch.stack(trees, dim=dim)


# ---------------------------------------------------------------------------
# Forward rollout + local model
# ---------------------------------------------------------------------------


def rollout(model, z0, U, encoding: StateEncoding, u_min=None, u_max=None):
    """Sequential rollout recording the per-step model aux.

    Returns (Z (..., N+1, nz), AUX stacked over time at dim -2 of each
    leaf's batch, i.e. one entry per step).
    """
    N = U.shape[-2]
    z, mstate = z0, model.init_state(batch_shape=z0.shape[:-1])
    Zs, auxs = [z0], []
    for i in range(N):
        u = U[..., i, :]
        if u_min is not None and u_max is not None:
            u = clamp(u, u_min, u_max)
        z, mstate, aux = model.step(z, u, i, mstate, encoding)
        Zs.append(z)
        auxs.append(aux)
    return torch.stack(Zs, dim=-2), _stack_tree(auxs, dim=0)


def local_model(Z, U, AUX, model, cost,
                encoding: StateEncoding = StateEncoding.DEFAULT,
                model_opts=None, cost_opts=None, u_min=None, u_max=None,
                approximate_hessians=False):
    """Local quadratic model of an already-rolled-out trajectory.

    No sequential loop: the cost's closed form (or vmapped autodiff)
    and the vmapped dynamics Jacobians cover all N steps at once. Z and U
    may carry leading lane dims (a batch of solves, AUX's leaves then
    (N, *lanes, ...)): the steps of every lane go through one call, the
    terminal cost through one call over the lanes.

    Returns:
        (Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu), contiguous, with
        L/L_z/L_zz covering N+1 entries (terminal included).
    """
    model_opts = model_opts or {}
    cost_opts = cost_opts or {}
    N = U.shape[-2]
    U_eff = U
    if u_min is not None and u_max is not None:
        U_eff = clamp(U, u_min, u_max)
    L_run, L_z_run, L_u, L_zz_run, L_uz, L_uu = quadratize_cost(
        cost, Z[..., :-1, :], U_eff, encoding,
        approximate=approximate_hessians, **cost_opts)
    _, F_z, F_u = linearize_dynamics(model, Z[..., :-1, :], U_eff, AUX,
                                     encoding, **model_opts)

    def terminal(z):
        l_T, l_z_T, _, l_zz_T, _, _ = eval_cost(
            cost, z, None, N, terminal=True, encoding=encoding,
            approximate=approximate_hessians, **cost_opts)
        return l_T, l_z_T, l_zz_T

    z_T = Z[..., -1, :]
    lane = z_T.shape[:-1]
    if lane:
        l_T, l_z_T, l_zz_T = (t.reshape(lane + t.shape[1:]) for t in
                              torch.func.vmap(terminal)(
                                  z_T.reshape(-1, z_T.shape[-1])))
    else:
        l_T, l_z_T, l_zz_T = terminal(z_T)

    L = torch.cat([L_run, l_T[..., None]], dim=-1)
    L_z = torch.cat([L_z_run, l_z_T[..., None, :]], dim=-2)
    L_zz = torch.cat([L_zz_run, l_zz_T[..., None, :, :]], dim=-3)
    return tuple(t.contiguous() for t in
                 (Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu))


def forward(z0, U, model, cost, encoding: StateEncoding = StateEncoding.DEFAULT,
            model_opts=None, cost_opts=None, u_min=None, u_max=None,
            approximate_hessians=False):
    """Forward pass: rollout, then the full local quadratic model."""
    Z, AUX = rollout(model, z0, U, encoding, u_min=u_min, u_max=u_max)
    return local_model(Z, U, AUX, model, cost, encoding, model_opts,
                       cost_opts, u_min=u_min, u_max=u_max,
                       approximate_hessians=approximate_hessians)


# ---------------------------------------------------------------------------
# Backward Riccati recursion
# ---------------------------------------------------------------------------


def Q(F_z, F_u, L_z, L_u, L_zz, L_uz, L_uu, V_z, V_zz):
    """Q-function derivatives, symmetrized; batched over leading dims."""
    Q_z = L_z + _mv(_T(F_z), V_z)
    Q_u = L_u + _mv(_T(F_u), V_z)
    V_zz_F_z = V_zz @ F_z
    Q_zz = L_zz + _T(F_z) @ V_zz_F_z
    Q_zz = 0.5 * (Q_zz + _T(Q_zz))
    Q_uz = L_uz + _T(F_u) @ V_zz_F_z
    Q_uu = L_uu + _T(F_u) @ (V_zz @ F_u)
    Q_uu = 0.5 * (Q_uu + _T(Q_uu))
    return Q_z, Q_u, Q_zz, Q_uz, Q_uu


def _lane_reg(reg, trailing):
    """``reg`` broadcastable against a lane-batched tensor with
    ``trailing`` dims after the lane dims: a host scalar as it is, a
    tensor of the lane shape (a reg per solve) with ``trailing`` unit dims
    appended."""
    if isinstance(reg, torch.Tensor) and reg.dim():
        return reg.reshape(reg.shape + (1,) * trailing)
    return reg


def _psd_clamp_with_reg(Q_uu, reg):
    """(Q_uu_reg, Q_uu_inv) by eigenvalue clamping at 1e-12 plus ``reg``:
    closed form for 1x1 action blocks, fixed-sweep Jacobi (``small_eigh``)
    up to ``SMALL_EIGH_N``, ``torch.linalg.eigh`` past it. ``reg`` is a
    scalar or a tensor of Q_uu's lane shape (a reg per solve)."""
    m = Q_uu.shape[-1]
    floor = torch.tensor(1e-12, dtype=Q_uu.dtype, device=Q_uu.device)
    if m == 1:
        e = torch.where(Q_uu < 0, floor, Q_uu) + _lane_reg(reg, 2)
        return e, 1.0 / e
    if m <= SMALL_EIGH_N:
        e, E = small_eigh(Q_uu, sort=False)
    else:
        e, E = torch.linalg.eigh(0.5 * (Q_uu + _T(Q_uu)))
    e = torch.where(e < 0, floor, e) + _lane_reg(reg, 1)
    Q_uu_reg = (E * e[..., None, :]) @ _T(E)
    Q_uu_inv = (E / e[..., None, :]) @ _T(E)
    return Q_uu_reg, Q_uu_inv


def _all_finite(t, dims):
    return torch.isfinite(t).flatten(-dims).all(-1)


def backward(Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu, reg=0.0,
             v_zz_reg=False, u_min=None, u_max=None, U=None):
    """Riccati backward as a reverse loop; also K1's plain version
    (``ops/backward_kernel.py``, unconstrained with Q_uu regularization).

    Three modes, as in ``pddp_tpu``:
     * Q_uu regularization (default): the eigen clamp of Q_uu plus ``reg``;
     * ``v_zz_reg``: the u-blocks are recomputed against V_zz + reg I and
       the gains come from their Cholesky factor;
     * constrained (``u_min`` and ``u_max``, with the nominal actions
       ``U``): k from ``boxqp`` within [u_min - U_i, u_max - U_i],
       warm-started from k_{i+1}, and K on the free dimensions from the
       box-QP's masked factor.

    Inputs carry leading batch dims before the time axis; ``reg`` is a
    scalar or a tensor of those dims' shape (a reg per solve).

    Returns:
        (k (..., N, nu), K (..., N, nu, nz), ok (...) bool): ok is False
        where a step failed anywhere in the recursion (a non-finite gain
        or factor, or a box-QP status below 1).
    """
    constrained = u_min is not None and u_max is not None
    N = L_u.shape[-2]
    V_z = L_z[..., N, :]
    V_zz = L_zz[..., N, :, :]
    if v_zz_reg:
        reg_eye = _lane_reg(reg, 2) * torch.eye(
            F_z.shape[-1], dtype=V_zz.dtype, device=V_zz.device)
    k_next = torch.zeros_like(L_u[..., 0, :])
    # The default mode checks its gains once, after the loop.
    ok = torch.ones(L_u.shape[:-2], dtype=torch.bool, device=L_u.device)
    step_ok = None
    ks, Ks = [None] * N, [None] * N
    for i in range(N - 1, -1, -1):
        ins = (F_z[..., i, :, :], F_u[..., i, :, :], L_z[..., i, :],
               L_u[..., i, :], L_zz[..., i, :, :], L_uz[..., i, :, :],
               L_uu[..., i, :, :])
        Q_z, Q_u, Q_zz, Q_uz, Q_uu = Q(*ins, V_z, V_zz)
        if v_zz_reg:
            _, lin_Q_u, _, lin_Q_uz, Q_uu_reg = Q(*ins, V_z, V_zz + reg_eye)
            U_chol = _cholesky_upper(Q_uu_reg)
            step_ok = _all_finite(U_chol, 2)
            if not constrained:
                kK = -chol_solve(U_chol, torch.cat([lin_Q_u[..., None],
                                                    lin_Q_uz], dim=-1))
                k_i, K_i = kK[..., 0], kK[..., 1:]
        else:
            lin_Q_u, lin_Q_uz = Q_u, Q_uz
            Q_uu_reg, Q_uu_inv = _psd_clamp_with_reg(Q_uu, reg)
            if not constrained:
                k_i = -_mv(Q_uu_inv, Q_u)
                K_i = -(Q_uu_inv @ Q_uz)
        if constrained:
            U_i = U[..., i, :]
            res = boxqp(k_next, Q_uu_reg, lin_Q_u, u_min - U_i, u_max - U_i)
            k_i = res.x
            step_ok = res.result >= 1
            if v_zz_reg:
                step_ok = step_ok & _all_finite(res.U_free, 2)
            free_f = res.free.to(k_i.dtype)[..., :, None]
            K_i = -chol_solve(res.U_free, lin_Q_uz * free_f) * free_f
        # V updates use the unregularized Q_uu/Q_uz with correction terms,
        # since k, K came from the regularized quantities.
        K_iT = _T(K_i)
        V_z = (Q_z + _mv(K_iT, Q_u) + _mv(K_iT, _mv(Q_uu, k_i))
               + _mv(_T(Q_uz), k_i))
        V_zz = Q_zz + K_iT @ (Q_uu @ K_i) + K_iT @ Q_uz + _T(Q_uz) @ K_i
        V_zz = 0.5 * (V_zz + _T(V_zz))
        if step_ok is not None:
            ok = ok & step_ok
        ks[i], Ks[i], k_next = k_i, K_i, k_i
    k = torch.stack(ks, dim=-2)
    K = torch.stack(Ks, dim=-3)
    if not (constrained or v_zz_reg):
        ok = _all_finite(k, 2) & _all_finite(K, 3)
    return k, K, ok


# ---------------------------------------------------------------------------
# Line search
# ---------------------------------------------------------------------------


def control_law(model, Z, U, k, K, alphas,
                encoding: StateEncoding = StateEncoding.DEFAULT,
                model_opts=None, u_min=None, u_max=None,
                cost=None, cost_opts=None, with_aux=False,
                cost_in_scan=False):
    """Batched-alpha closed-loop rollout; also K2's plain version.

    All A candidates roll out at once along a candidate axis. With
    ``cost`` the candidate costs come from one batched post-pass after
    the loop, or, with ``cost_in_scan``, accumulate step by step inside
    it (K2's order of summation).

    Args:
        Z (..., N+1, nz), U (..., N, nu), k (..., N, nu),
        K (..., N, nu, nz), alphas (A,).

    Returns:
        (Z_new (..., N+1, A, nz), U_new (..., N, A, nu))
        [, J (..., A) when cost is given]
        [, AUX (one entry per step, each (..., A, ...)) when with_aux].
    """
    model_opts = model_opts or {}
    cost_opts = cost_opts or {}
    A = alphas.shape[0]
    N = U.shape[-2]
    batch = Z.shape[:-2]
    in_scan = cost is not None and cost_in_scan

    z = Z[..., 0, None, :].expand(batch + (A,) + Z.shape[-1:])
    mstate = model.init_state(batch_shape=batch + (A,))
    a_col = alphas[:, None]
    J = 0.0
    Zs, Us, auxs = [z], [], []
    for i in range(N):
        dz = z - Z[..., i, None, :]
        du = a_col * k[..., i, None, :] + dz @ _T(K[..., i, :, :])
        u = U[..., i, None, :] + du
        if u_min is not None and u_max is not None:
            u = clamp(u, u_min, u_max)
        if in_scan:
            J = J + cost(z, u, i, terminal=False, encoding=encoding,
                         **cost_opts)
        z, mstate, aux = model.step(z, u, i, mstate, encoding, **model_opts)
        Zs.append(z)
        Us.append(u)
        auxs.append(aux)

    Z_new = torch.stack(Zs, dim=-3)
    U_new = torch.stack(Us, dim=-3)
    result = (Z_new, U_new)
    if cost is not None:
        if in_scan:
            J = J + cost(z, None, N, terminal=True, encoding=encoding,
                         **cost_opts)
        else:
            J = trajectory_cost(cost, Z_new, U_new, encoding, cost_opts)
        result = result + (J,)
    if with_aux:
        result = result + (_stack_tree(auxs, dim=0),)
    return result


def linear_control_law(Z, U, F_z, F_u, k, K, alphas, u_min=None,
                       u_max=None):
    """Linearized line-search rollout: the deviations propagate through
    the stored Jacobians instead of the model.

    Args:
        Z (..., N+1, nz), U (..., N, nu), F_z (..., N, nz, nz),
        F_u (..., N, nz, nu), k (..., N, nu), K (..., N, nu, nz),
        alphas (A,).

    Returns:
        (Z_new (..., N+1, A, nz), U_new (..., N, A, nu)).
    """
    A = alphas.shape[0]
    N = U.shape[-2]
    batch = Z.shape[:-2]
    z = Z[..., 0, None, :].expand(batch + (A,) + Z.shape[-1:])
    a_col = alphas[:, None]
    Zs, Us = [z], []
    for i in range(N):
        u_i = U[..., i, None, :]
        dz = z - Z[..., i, None, :]
        du = a_col * k[..., i, None, :] + dz @ _T(K[..., i, :, :])
        if u_min is not None and u_max is not None:
            du = clamp(du, u_min - u_i, u_max - u_i)
        dz_next = dz @ _T(F_z[..., i, :, :]) + du @ _T(F_u[..., i, :, :])
        z = Z[..., i + 1, None, :] + dz_next
        Zs.append(z)
        Us.append(u_i + du)
    return torch.stack(Zs, dim=-3), torch.stack(Us, dim=-3)


def trajectory_cost(cost, Z, U, encoding: StateEncoding = StateEncoding.DEFAULT,
                    cost_opts=None):
    """Total trajectory cost, batched over the dims after time.

    Z: (N+1, ..., nz), U: (N, ..., nu), or with leading solve dims as
    ``control_law`` returns them: the time axis is dim -3 of Z when Z has
    more than two dims. Returns the summed cost over time.
    """
    cost_opts = cost_opts or {}
    t_dim = 0 if Z.dim() <= 2 else Z.dim() - 3
    N = U.shape[t_dim]
    Zm = Z.movedim(t_dim, 0)
    Um = U.movedim(t_dim, 0)
    idx = torch.arange(N, device=Z.device).reshape(
        (N,) + (1,) * (Um.dim() - 2))
    L = cost(Zm[:-1], Um, idx, terminal=False, encoding=encoding,
             **cost_opts)
    l_T = cost(Zm[-1], None, N, terminal=True, encoding=encoding, **cost_opts)
    if t_dim:
        # Lanes of a batch of solves: each candidate's steps summed as one
        # contiguous row, an order that does not depend on how many lanes
        # share the call (a chunked batch gives the bits of the whole).
        return L.movedim(0, -1).contiguous().sum(-1) + l_T
    return L.sum(dim=0) + l_T


# ---------------------------------------------------------------------------
# The solve loop
# ---------------------------------------------------------------------------


def _increase_reg(mu, delta, mu_min, delta_0):
    """Tassa schedule increase."""
    delta = np.maximum(1.0, delta) * delta_0
    mu = np.maximum(mu_min, mu * delta)
    return mu, delta


def _decrease_reg(mu, delta, mu_min, delta_0):
    """Tassa schedule decrease."""
    delta = np.minimum(1.0, delta) / delta_0
    mu = mu * delta
    mu = type(mu)(0.0) if mu <= mu_min else mu
    return mu, delta


def _check_options(opts: ILQROptions):
    if opts.riccati_mode not in ("scan", "parallel", "kernel"):
        raise ValueError("unknown riccati_mode {!r}".format(
            opts.riccati_mode))


def _param_dtypes(obj):
    return [v.dtype for v in vars(obj).values()
            if isinstance(v, torch.Tensor) and v.is_floating_point()]


def _solve_dtype(z0, U0, model, cost):
    """The promoted floating dtype of the inputs and every parameter
    tensor of the model and cost (what JAX's solve probes abstractly)."""
    dtype = torch.promote_types(z0.dtype, U0.dtype)
    for d in _param_dtypes(model) + _param_dtypes(cost):
        dtype = torch.promote_types(dtype, d)
    return dtype


def _solver_steps(model, cost, opts, encoding, model_opts, cost_opts, u_min,
                  u_max, alphas):
    """(local_fn, backward_fn, line_search_fn) of a solve, each over
    leading lane dims where the inputs have them: the local model, the
    Riccati backward of the options' mode under ``pddp_tpu``'s gate (the
    reg a float, or a tensor of the lane shape) and the line search."""
    constrained = u_min is not None and u_max is not None

    def local_fn(Z, U, AUX):
        return local_model(Z, U, AUX, model, cost, encoding, model_opts,
                           cost_opts, u_min=u_min, u_max=u_max,
                           approximate_hessians=opts.approximate_hessians)

    def backward_fn(derivs, U_cur, reg):
        # pddp_tpu's gate: constrained and v_zz_reg solves take the scan,
        # and so do action sizes past the kernel's in kernel mode.
        if not constrained and not opts.v_zz_reg:
            if opts.riccati_mode == "parallel":
                from ..ops.riccati import parallel_backward
                return parallel_backward(*derivs, reg=reg)
            if opts.riccati_mode == "kernel":
                from ..ops.backward_kernel import (kernel_backward,
                                                   supports_kernel_backward)
                if supports_kernel_backward(derivs[5], derivs[1]):
                    return kernel_backward(*derivs, reg=reg)
        return backward(*derivs, reg=reg, v_zz_reg=opts.v_zz_reg,
                        u_min=u_min, u_max=u_max, U=U_cur)

    def line_search_fn(Z, U, k, K_new):
        if opts.fused_rollout and not model_opts:
            from ..ops.fused_rollout import (fused_control_law,
                                             supports_fused_rollout)
            # pddp_tpu's gate: stateful models take the scan.
            if supports_fused_rollout(model, cost, encoding,
                                      cost_opts=cost_opts):
                if encoding == StateEncoding.IGNORE_UNCERTAINTY:
                    return fused_control_law(
                        model, Z, U, k, K_new, alphas, encoding, cost=cost,
                        cost_opts=cost_opts, u_min=u_min, u_max=u_max,
                        with_aux=True)
                # Belief states: trajectories from the kernel, the cost
                # as one batched post-pass.
                Z_b, U_b, AUX_b = fused_control_law(
                    model, Z, U, k, K_new, alphas, encoding, u_min=u_min,
                    u_max=u_max, with_aux=True)
                J_b = trajectory_cost(cost, Z_b, U_b, encoding, cost_opts)
                return Z_b, U_b, J_b, AUX_b
        return control_law(model, Z, U, k, K_new, alphas, encoding,
                           model_opts, u_min=u_min, u_max=u_max, cost=cost,
                           cost_opts=cost_opts, with_aux=True,
                           cost_in_scan=opts.cost_in_scan)

    return local_fn, backward_fn, line_search_fn


def solve(model, cost, z0, U0, opts: ILQROptions,
          encoding: StateEncoding = StateEncoding.DEFAULT,
          model_opts=None, cost_opts=None, mu0=0.0, delta0=None,
          n_iterations=None, on_iteration=None) -> ILQRResult:
    """Full iLQR solve with the reference's fit/step structure.

    The outer loop refreshes the local quadratic model once per accepted
    step; the inner loop retries backward + line search with escalating
    regularization until a step is accepted, the regularization exceeds
    ``max_reg`` or ``max_evals`` evaluations are spent. The solve runs on
    the device of ``z0``/``U0``; the scalars of the status machine (J,
    mu, delta) stay on the host in the solve's dtype, one transfer per
    evaluation.

    Args:
        on_iteration: optional callback (iteration, state, Z, U, J),
            called once per outer iteration.
    """
    _check_options(opts)
    N, nu = U0.shape
    nz = z0.shape[-1]
    dtype = _solve_dtype(z0, U0, model, cost)
    device = U0.device
    z0 = z0.to(dtype)
    U0 = U0.to(dtype)
    sc = np.dtype(str(dtype).replace("torch.", "")).type
    u_min, u_max = (None if b is None else torch.as_tensor(
        b, dtype=dtype, device=device) for b in (opts.u_min, opts.u_max))

    alphas = (default_fit_alphas(dtype, device) if opts.alphas is None
              else torch.as_tensor(opts.alphas, dtype=dtype, device=device))
    n_iter = opts.n_iterations if n_iterations is None else n_iterations
    tol, max_reg = sc(opts.tol), sc(opts.max_reg)
    mu_min, delta_0 = sc(opts.mu_min), sc(opts.delta_0)

    local_fn, backward_fn, line_search_fn = _solver_steps(
        model, cost, opts, encoding, model_opts, cost_opts, u_min, u_max,
        alphas)

    # One rollout up front; afterwards the accepted trajectory always
    # comes out of the line search, with its aux recorded.
    Z, AUX = rollout(model, z0, U0, encoding, u_min=u_min, u_max=u_max)
    U = U0
    derivs = local_fn(Z, U, AUX)
    J_opt = sc(derivs[3].sum().item())
    K = torch.zeros((N, nu, nz), dtype=dtype, device=device)
    mu = sc(mu0)
    delta = sc(opts.delta_0 if delta0 is None else delta0)
    state = iLQRState.UNDEFINED
    accepted = evals = 0

    while (not state.is_terminal() and accepted < n_iter
           and evals < opts.max_evals):
        state = iLQRState.UNDEFINED
        accept = False
        retry = True
        while retry and evals < opts.max_evals:
            k, K_new, ok = backward_fn(derivs, U, float(mu))
            Z_b, U_b, J_b, AUX_b = line_search_fn(derivs[0], U, k, K_new)
            # A diverged candidate gives NaN, which argmin would pick:
            # non-finite candidates count as +inf instead.
            amin = torch.argmin(torch.where(torch.isfinite(J_b), J_b,
                                            torch.inf))
            # The one transfer of the evaluation: ok, J and the winner.
            ok_h, J_new, amin = torch.stack(
                [ok.to(dtype), J_b[amin], amin.to(dtype)]).tolist()
            J_new, amin = sc(J_new), int(amin)

            accept = bool(ok_h) and bool(np.isfinite(J_new)) and J_new < J_opt
            converged = accept and abs(J_opt - J_new) / J_opt < tol
            mu_inc, delta_inc = _increase_reg(mu, delta, mu_min, delta_0)
            mu_dec, delta_dec = _decrease_reg(mu, delta, mu_min, delta_0)
            reg_exceeded = mu_inc >= max_reg
            if accept:
                state = (iLQRState.CONVERGED if converged
                         else iLQRState.ACCEPTED)
                Z = Z_b[:, amin].contiguous()
                U = U_b[:, amin].contiguous()
                K, J_opt = K_new, J_new
                AUX = _tree_map(lambda a: a[:, amin], AUX_b)
                mu, delta = mu_dec, delta_dec
            else:
                state = (iLQRState.MAX_REG if reg_exceeded else
                         iLQRState.REJECTED if ok_h else iLQRState.NOT_PD)
                mu, delta = mu_inc, delta_inc
            evals += 1
            retry = not accept and not reg_exceeded

        if accept:
            accepted += 1
            # The next iteration's local model, unless the loop ends here
            # (nothing reads it after the loop).
            if (not state.is_terminal() and accepted < n_iter
                    and evals < opts.max_evals):
                derivs = local_fn(Z, U, AUX)
        if on_iteration is not None:
            on_iteration(accepted - 1, state, Z, U, float(J_opt))

    return ILQRResult(Z=Z, U=U, K=K, J_opt=float(J_opt), state=state,
                      mu=float(mu), delta=float(delta), iterations=accepted,
                      evals=evals)


def step_once(model, cost, z0, U0, opts: ILQROptions,
              encoding: StateEncoding = StateEncoding.DEFAULT,
              model_opts=None, cost_opts=None, mu0=0.0,
              delta0=None) -> ILQRResult:
    """A single iLQR step with retry semantics (the MPC path)."""
    if opts.alphas is None:
        opts = dataclasses.replace(
            opts, alphas=default_step_alphas(U0.dtype, U0.device))
    return solve(model, cost, z0, U0, opts, encoding=encoding,
                 model_opts=model_opts, cost_opts=cost_opts, mu0=mu0,
                 delta0=delta0, n_iterations=1)


#: evaluations (backward + line search over every lane) run by
#: ``solve_lanes``, counted as the kernels' wrappers count their launches.
lane_evaluations = 0


def _tree_zip(fn, a, b):
    """``fn`` over the paired tensors of two nests of the same structure."""
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_zip(fn, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return {k: _tree_zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _lanes_where(mask, new, old, lane_dim=0):
    """``new`` where ``mask`` (B,) else ``old``, the lane axis at
    ``lane_dim``."""
    shape = (1,) * lane_dim + mask.shape + (1,) * (new.dim() - lane_dim - 1)
    return torch.where(mask.reshape(shape), new, old)


def _terminal_lanes(state):
    return ((state == int(iLQRState.CONVERGED))
            | (state == int(iLQRState.MAX_REG)))


def solve_lanes(model, cost, z0s, U0s, opts: ILQROptions,
                encoding: StateEncoding = StateEncoding.DEFAULT
                ) -> ILQRResult:
    """B independent solves in one loop, each lane with ``solve``'s status
    machine, as ``pddp_tpu``'s vmap of its solve has it.

    Every lane carries its own Z, U, AUX, K, J, mu, delta, state,
    accepted iterations and evaluations, on the device. The outer loop
    runs while any lane is active (not terminal, fewer than
    ``n_iterations`` accepted, fewer than ``max_evals`` evaluations); the
    inner loop while any active lane retries. Every evaluation runs all B
    lanes through the backward (the reg of each lane its own) and the
    line search, and only the lanes that run take its result: the others
    keep their carry, as vmap's select does. After the inner loop the
    lanes that accepted and go on get a fresh local model, computed for
    those lanes only. Each evaluation makes one device-to-host transfer:
    whether any lane retries, whether any lane goes on, and which lanes
    need a fresh local model.

    Args:
        z0s (B, nz), U0s (B, N, nu).

    Returns:
        An ``ILQRResult`` whose every field has a leading B: tensors on
        the inputs' device, ``state`` the ``iLQRState`` codes (int32).
    """
    global lane_evaluations
    _check_options(opts)
    B, N, nu = U0s.shape
    nz = z0s.shape[-1]
    dtype = _solve_dtype(z0s, U0s, model, cost)
    device = U0s.device
    z0s, U0s = z0s.to(dtype), U0s.to(dtype)
    u_min, u_max = (None if b is None else torch.as_tensor(
        b, dtype=dtype, device=device) for b in (opts.u_min, opts.u_max))
    alphas = (default_fit_alphas(dtype, device) if opts.alphas is None
              else torch.as_tensor(opts.alphas, dtype=dtype, device=device))
    n_iter, max_evals = opts.n_iterations, opts.max_evals
    tol, max_reg, mu_min, delta_0 = (
        torch.tensor(v, dtype=dtype, device=device)
        for v in (opts.tol, opts.max_reg, opts.mu_min, opts.delta_0))
    codes = {s: torch.tensor(int(s), dtype=torch.int32, device=device)
             for s in iLQRState}
    local_fn, backward_fn, line_search_fn = _solver_steps(
        model, cost, opts, encoding, None, None, u_min, u_max, alphas)

    Z, AUX = rollout(model, z0s, U0s, encoding, u_min=u_min, u_max=u_max)
    U = U0s
    derivs = local_fn(Z, U, AUX)
    J_opt = derivs[3].sum(-1)
    K = torch.zeros((B, N, nu, nz), dtype=dtype, device=device)
    mu = torch.zeros(B, dtype=dtype, device=device)
    delta = torch.full((B,), opts.delta_0, dtype=dtype, device=device)
    state = torch.full((B,), int(iLQRState.UNDEFINED), dtype=torch.int32,
                       device=device)
    accepted = torch.zeros(B, dtype=torch.int32, device=device)
    evals = torch.zeros(B, dtype=torch.int32, device=device)
    lanes = torch.arange(B, device=device)

    active = torch.full((B,), n_iter > 0 and max_evals > 0,
                        dtype=torch.bool, device=device)
    go_on = n_iter > 0 and max_evals > 0
    while go_on:
        state = torch.where(active, codes[iLQRState.UNDEFINED], state)
        retry = active
        took = torch.zeros_like(active)
        go_inner = True
        while go_inner:
            lane_evaluations += 1
            run = retry & (evals < max_evals)
            k, K_new, ok = backward_fn(derivs, U, mu)
            Z_b, U_b, J_b, AUX_b = line_search_fn(derivs[0], U, k, K_new)
            # Non-finite candidates count as +inf in each lane's argmin.
            amin = torch.argmin(torch.where(torch.isfinite(J_b), J_b,
                                            torch.inf), dim=-1)
            J_new = J_b[lanes, amin]
            accept = run & ok & torch.isfinite(J_new) & (J_new < J_opt)
            converged = accept & ((J_opt - J_new).abs() / J_opt < tol)
            # The Tassa schedule, as _increase_reg and _decrease_reg.
            delta_inc = torch.clamp_min(delta, 1.0) * delta_0
            mu_inc = torch.maximum(mu_min, mu * delta_inc)
            delta_dec = torch.clamp_max(delta, 1.0) / delta_0
            mu_dec = mu * delta_dec
            mu_dec = torch.where(mu_dec <= mu_min, 0.0, mu_dec)
            reg_exceeded = mu_inc >= max_reg

            new_state = torch.where(
                accept,
                torch.where(converged, codes[iLQRState.CONVERGED],
                            codes[iLQRState.ACCEPTED]),
                torch.where(reg_exceeded, codes[iLQRState.MAX_REG],
                            torch.where(ok, codes[iLQRState.REJECTED],
                                        codes[iLQRState.NOT_PD])))
            state = torch.where(run, new_state, state)
            Z = _lanes_where(accept, Z_b[lanes, :, amin], Z)
            U = _lanes_where(accept, U_b[lanes, :, amin], U)
            AUX = _tree_zip(lambda new, old: _lanes_where(
                accept, new[:, lanes, amin], old, lane_dim=1), AUX_b, AUX)
            K = _lanes_where(accept, K_new, K)
            J_opt = torch.where(accept, J_new, J_opt)
            mu = torch.where(run, torch.where(accept, mu_dec, mu_inc), mu)
            delta = torch.where(run, torch.where(accept, delta_dec,
                                                 delta_inc), delta)
            evals = evals + run.to(torch.int32)
            retry = run & ~accept & ~reg_exceeded
            took = took | accept
            # Where each lane stands if the inner loop ends here.
            active = (~_terminal_lanes(state)
                      & (accepted + took.to(torch.int32) < n_iter)
                      & (evals < max_evals))
            # The one transfer of the evaluation.
            flags = torch.cat([(retry & (evals < max_evals)).any()[None],
                               active.any()[None], took & active]).tolist()
            go_inner = flags[0]
        accepted = accepted + took.to(torch.int32)
        go_on = flags[1]
        fresh = [b for b, f in enumerate(flags[2:]) if f]
        if fresh:
            if len(fresh) == B:
                derivs = local_fn(Z, U, AUX)
            else:
                idx = torch.tensor(fresh, device=device)
                sub = local_fn(Z[idx], U[idx],
                               _tree_map(lambda a: a[:, idx], AUX))
                derivs = tuple(d.index_copy(0, idx, s)
                               for d, s in zip(derivs, sub))

    return ILQRResult(Z=Z, U=U, K=K, J_opt=J_opt, state=state, mu=mu,
                      delta=delta, iterations=accepted, evals=evals)


# ---------------------------------------------------------------------------
# Stateful controller
# ---------------------------------------------------------------------------


class iLQRController(Controller):
    """Iterative Linear Quadratic Regulator controller.

    A stateful wrapper over the functional core above with ``pddp_tpu``'s
    constructor and fit/step/forward surface: it holds the warm-start
    state (the nominal Z, U and K, and mu/delta) between calls. The solve
    runs on the device of the env's state.
    """

    def __init__(self, env, model, cost, model_opts=None, cost_opts=None,
                 riccati_mode="scan", fused_rollout=False, scan_unroll=1,
                 v_zz_reg=False, **kwargs):
        """Args beyond (env, model, cost, model_opts, cost_opts):

        riccati_mode, fused_rollout, v_zz_reg: threaded into every solve
        (see ``ILQROptions``): "kernel" runs the backward in K1,
        ``fused_rollout`` the line search in K2, ``v_zz_reg`` regularizes
        V_zz instead of Q_uu. ``scan_unroll`` is accepted for
        ``pddp_tpu``'s signature and ignored.
        """
        super().__init__()
        del scan_unroll, kwargs
        self.env = env
        self.model = model
        self.cost = cost
        self._model_opts = model_opts or {}
        self._cost_opts = cost_opts or {}
        self._riccati_mode = riccati_mode
        self._fused_rollout = fused_rollout
        self._v_zz_reg = v_zz_reg

        self._mu = 0.0
        self._mu_min = 1e-6
        self._delta_0 = 2.0
        self._delta = self._delta_0

        self._Z_nominal = None
        self._U_nominal = None
        self._K = None
        #: the ILQRResult of the last solve (fit or step): its end state,
        #: cost, iterations and evaluations.
        self.last_result = None

    def _make_opts(self, n_iterations, tol, max_reg, u_min, u_max, alphas,
                   max_evals=None):
        if max_evals is None:
            max_evals = 2 * int(n_iterations) + 64
        return ILQROptions(
            n_iterations=n_iterations, tol=tol, max_reg=max_reg,
            mu_min=self._mu_min, delta_0=self._delta_0, alphas=alphas,
            u_min=u_min, u_max=u_max, max_evals=max_evals,
            riccati_mode=self._riccati_mode,
            fused_rollout=self._fused_rollout, v_zz_reg=self._v_zz_reg)

    def _solve(self, z0, U, opts, encoding, on_iteration=None):
        result = solve(self.model, self.cost, z0, U, opts, encoding=encoding,
                       model_opts=self._model_opts,
                       cost_opts=self._cost_opts, mu0=self._mu,
                       delta0=self._delta, on_iteration=on_iteration)
        self._store(result)
        return result

    def fit(self, U, encoding: StateEncoding = StateEncoding.DEFAULT,
            n_iterations=50, tol=5e-6, max_reg=1e10, quiet=False,
            on_iteration=None, u_min=None, u_max=None, **kwargs):
        """Determines the optimal path from the env's current state.

        Args:
            U: initial actions (N, nu); a tensor keeps its dtype, numpy
                arrays are taken on the env's device.
            on_iteration: optional callback (iteration, state, Z, U, J),
                called once per outer iteration.

        Returns:
            Tuple (Z (N+1, nz), U (N, nu), state (iLQRState)).
        """
        z0 = self.env.get_state().encode(encoding)
        U = torch.as_tensor(U, device=z0.device)
        z0 = z0.to(U.dtype)
        self._reset_reg()
        opts = self._make_opts(n_iterations, tol, max_reg, u_min, u_max,
                               default_fit_alphas(U.dtype, U.device))
        result = self._solve(z0, U, opts, encoding, on_iteration)
        return self._Z_nominal, self._U_nominal, result.state

    def step(self, z0, U=None, i=0,
             encoding: StateEncoding = StateEncoding.DEFAULT, u_min=None,
             u_max=None, tol=5e-6, max_reg=1e10, **kwargs):
        """One warm-started optimization step from ``z0`` (at most 64
        evaluations, the step alphas), from the nominal actions unless
        ``U`` is given."""
        U = self._U_nominal if U is None else torch.as_tensor(U)
        z0 = torch.as_tensor(z0, dtype=U.dtype, device=U.device)
        opts = self._make_opts(1, tol, max_reg, u_min, u_max,
                               default_step_alphas(U.dtype, U.device),
                               max_evals=64)
        return self._solve(z0, U, opts, encoding).state

    def forward(self, z, i, encoding: StateEncoding = StateEncoding.DEFAULT,
                mpc=False, ignore_uncertainty=True, u_min=None, u_max=None,
                warm_reg=False, **kwargs):
        """The control at step ``i`` for the encoded state ``z``.

        mpc=False: the feedback law around the fitted nominal trajectory,
        on the mean's deviation (``ignore_uncertainty``) or on the whole
        encoded state's.
        mpc=True: one warm-started ``step`` from ``z``, then the nominal
        actions shift left by one. The regularization restarts from zero
        unless ``warm_reg`` carries mu and delta over from the last step.
        """
        if not mpc:
            if self._U_nominal is None:
                raise RuntimeError(
                    "You need to either call fit or initialize _U_nominal")
            if self._Z_nominal is None:
                return self._U_nominal[i]
            z = torch.as_tensor(z, dtype=self._Z_nominal.dtype,
                                device=self._Z_nominal.device)
            if ignore_uncertainty:
                x = decode_mean(z, encoding)
                dx = x - decode_mean(self._Z_nominal[i], encoding)
                du = self._K[i, :, :x.shape[0]] @ dx
            else:
                du = self._K[i] @ (z - self._Z_nominal[i])
            return self._U_nominal[i] + du

        if not warm_reg:
            self._reset_reg()
        self.step(z, i=i, encoding=encoding, u_min=u_min, u_max=u_max,
                  **kwargs)
        u = self._U_nominal[0]
        self._U_nominal = torch.cat([self._U_nominal[1:],
                                     self._U_nominal[-1:]], dim=0)
        return u

    def state_dict(self):
        """Warm-start state for checkpointing."""
        return {"Z_nominal": self._Z_nominal, "U_nominal": self._U_nominal,
                "K": self._K, "mu": torch.tensor(self._mu),
                "delta": torch.tensor(self._delta)}

    def load_state_dict(self, state):
        """Restores warm-start state saved by :meth:`state_dict` (or made
        from ``pddp_tpu``'s by ``convert.controller_state``)."""
        self._Z_nominal = state.get("Z_nominal")
        self._U_nominal = state.get("U_nominal")
        self._K = state.get("K")
        if "mu" in state:
            self._mu = float(state["mu"])
        if "delta" in state:
            self._delta = float(state["delta"])
        return self

    def _store(self, result: ILQRResult):
        self.last_result = result
        self._Z_nominal = result.Z
        self._U_nominal = result.U
        self._K = result.K
        self._mu = float(result.mu)
        self._delta = float(result.delta)

    def _reset_reg(self):
        self._mu = 0.0
        self._delta = self._delta_0
