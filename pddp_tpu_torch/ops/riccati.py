"""The Riccati backward in O(log N) depth (port of ``pddp_tpu/ops/riccati.py``).

The affine-LQR backward pass as an associative scan. Each step is a
conditional value function e = (A, b, C, eta, J),

    V(x, z) = 1/2 (z - A x - b)^T C^+ (z - A x - b)
              + 1/2 x^T J x - eta^T x  (+ const),

after the cross and linear action terms are removed by completing the
square in u (L_uu > 0, as for the QR costs with R > 0). Two adjacent
elements (a then b) compose as

    M = I + C_a J_b
    A = A_b M^-1 A_a                     b = A_b M^-1 (b_a + C_a eta_b) + b_b
    C = A_b M^-1 C_a A_b^T + C_b
    eta = A_a^T M^-T (eta_b - J_b b_a) + eta_a
    J = A_a^T M^-T J_b A_a + J_a

and a suffix scan of the N + 1 elements (the last the terminal cost)
gives every value function V_i(x) = 1/2 x^T S_i x + s_i^T x at once
(S_i = J, s_i = -eta), from which the gains follow in one batched step.

The scan is written out here: log2(N + 1) levels, each one batched
combine of the elements i and i + d over the horizon (d = 1, 2, 4, ...),
with any leading lane dims. Its order of combines is not
``lax.associative_scan``'s, so results agree with ``pddp_tpu``'s to
rounding.

Semantics against the sequential backward (``controllers.ilqr.backward``):
the same gains at reg = 0 where the eigenvalue clamp does not act
(``pddp_tpu/ops/riccati.py:35-36``: ~1e-10 in float64). With reg > 0 the
gains take Q_uu + reg I while the value recursion stays exact, which
differs from the sequential pass's regularization on the retry path
only. Constrained and ``v_zz_reg`` solves take the sequential pass.
"""

from __future__ import annotations

import torch

from ..controllers.ilqr import _all_finite, _lane_reg, _mv, _T
from ..utils.linalg import SMALL_EIGH_N, small_eigh, small_inv

__all__ = ["parallel_backward"]


def _inv(M):
    return small_inv(M) if M.shape[-1] <= 4 else torch.linalg.inv(M)


def _sym(A):
    return 0.5 * (A + _T(A))


def _combine(a, b):
    """The composition of conditional value functions a then b. C_a and
    J_b are symmetric, so (I + J_b C_a)^-1 = (M^-1)^T: one inverse serves
    both halves."""
    A1, b1, C1, e1, J1 = a
    A2, b2, C2, e2, J2 = b
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    Minv = _inv(eye + C1 @ J2)
    A2Minv = A2 @ Minv
    A = A2Minv @ A1
    b_ = _mv(A2Minv, b1 + _mv(C1, e2)) + b2
    C = _sym((A2Minv @ C1) @ _T(A2) + C2)
    A1TNinv = _T(Minv @ A1)
    eta = _mv(A1TNinv, e2 - _mv(J2, b1)) + e1
    J = _sym((A1TNinv @ J2) @ A1 + J1)
    return A, b_, C, eta, J


#: the time axis of each element part (A, b, C, eta, J).
_TIME_DIMS = (-3, -2, -3, -2, -3)


def _suffix_scan(elems):
    """out[i] = e_i then e_{i+1} ... then e_last, over the time axis: at
    level d = 1, 2, 4, ... every element i < n - d takes in element
    i + d, so after level d it holds the 2d elements from i on."""
    n = elems[1].shape[-2]
    d = 1
    while d < n:
        head = [t.narrow(a, 0, n - d) for t, a in zip(elems, _TIME_DIMS)]
        tail = [t.narrow(a, d, n - d) for t, a in zip(elems, _TIME_DIMS)]
        elems = tuple(torch.cat([c, t.narrow(a, n - d, d)], dim=a)
                      for c, t, a in zip(_combine(head, tail), elems,
                                         _TIME_DIMS))
        d *= 2
    return elems


def _psd_clamp_inv_with_reg(Q_uu, reg):
    """The inverse of the eigenvalue-clamped (at 1e-12), regularized Q_uu
    over the horizon (..., N, m, m); ``reg`` a scalar or a tensor of the
    lane shape."""
    m = Q_uu.shape[-1]
    floor = torch.tensor(1e-12, dtype=Q_uu.dtype, device=Q_uu.device)
    if m == 1:
        return 1.0 / (torch.where(Q_uu < 0, floor, Q_uu) + _lane_reg(reg, 3))
    if m <= SMALL_EIGH_N:
        e, E = small_eigh(Q_uu, sort=False)
    else:
        e, E = torch.linalg.eigh(_sym(Q_uu))
    e = torch.where(e < 0, floor, e) + _lane_reg(reg, 2)
    return (E / e[..., None, :]) @ _T(E)


def _across_blocks(elems, terminal, group):
    """(eta, J) of the value functions V_{i+1} of this rank's steps: the
    suffix scan over the whole horizon, its steps sharded over ``group``
    in contiguous blocks (rank 0 the first; the time axis leading) and
    ``terminal`` the terminal element. Two levels: the block's own suffix
    scan, then one all-gather of every block's composite element; the
    later blocks' composites and the terminal element, combined in order,
    close the block's scan."""
    from ..parallel.collectives import all_gather, group_rank, group_size
    size, rank = group_size(group), group_rank(group)
    local = _suffix_scan(elems)
    every = all_gather(torch.cat([t[0].reshape(1, -1) for t in local], 1),
                       group)
    composites = [c.reshape((size,) + t.shape[1:]) for c, t in zip(
        every.split([t[0].numel() for t in local], dim=1), local)]
    # tails[r] composes the blocks from r on, then the terminal element.
    tails = _suffix_scan(tuple(torch.cat([c, t])
                               for c, t in zip(composites, terminal)))
    tail = [t[rank + 1:rank + 2] for t in tails]
    rest = [t[1:] for t in local]
    closed = _combine(rest, [t.expand_as(r) for t, r in zip(tail, rest)])
    return (torch.cat([closed[3], tail[3]]), torch.cat([closed[4], tail[4]]))


def parallel_backward(Z, F_z, F_u, L, L_z, L_u, L_zz, L_uz, L_uu, reg=0.0,
                      group=None):
    """The Riccati backward in O(log N) depth: the interface and returns
    of ``controllers.ilqr.backward`` (unconstrained), leading lane dims
    before the time axis, ``reg`` a scalar or a tensor of the lane shape.

    ``group``: a process group whose ranks hold the horizon in contiguous
    blocks, as ``parallel.shard_over_horizon`` gives them (an unbatched
    local model): the N-long leaves (F_z, F_u, L_u, L_uz, L_uu) this
    rank's block of the steps, the (N+1)-long ones (Z, L, L_z, L_zz)
    whole. The scan then runs in two levels with one all-gather, and the
    returns are this rank's block of k and K, and ``ok`` over the whole
    horizon (every rank's). Where N does not divide by the group's size,
    ``shard_over_horizon`` leaves the N-long leaves whole (and shards the
    (N+1)-long ones if N + 1 divides); the (N+1)-long leaves are then
    gathered, and k and K come back whole.

    Returns:
        (k (..., N, nu), K (..., N, nu, nz), ok (...) bool).
    """
    del L  # the values do not enter the gains
    nu = L_u.shape[-1]
    lane = L_u.shape[:-2]
    nz = Z.shape[-1]
    dtype, device = Z.dtype, Z.device
    n = F_u.shape[-3]
    lo = 0
    sharded = False
    if group is not None:
        from ..parallel.collectives import (all_gather, any_rank,
                                            group_rank, group_size)
        if F_u.dim() != 3:
            raise ValueError("a horizon-sharded backward takes an "
                             "unbatched local model")
        size = group_size(group)
        if L_z.shape[0] * size == n + 1:   # (N+1)-long leaves in blocks
            L_z, L_zz = (all_gather(t, group) for t in (L_z, L_zz))
        sharded = L_z.shape[0] == n * size + 1
        if sharded:
            lo = group_rank(group) * n

    L_z_run, L_zz_run = L_z[..., lo:lo + n, :], L_zz[..., lo:lo + n, :, :]
    # Completing the square in u, v = u + L_uu^-1 (L_uz z + L_u):
    #   F~ = F_z - F_u L_uu^-1 L_uz      c~ = -F_u L_uu^-1 L_u
    #   X~ = L_zz - L_uz^T L_uu^-1 L_uz  r~ = L_z - L_uz^T L_uu^-1 L_u
    #   C = F_u L_uu^-1 F_u^T
    if nu <= 4:
        Luu_inv = small_inv(L_uu)

        def lsolve(M):
            return Luu_inv @ M
    else:
        def lsolve(M):
            return torch.linalg.solve(L_uu, M)
    Li_uz = lsolve(L_uz)
    Li_u = lsolve(L_u[..., None])[..., 0]
    F_tilde = F_z - F_u @ Li_uz
    c_tilde = -_mv(F_u, Li_u)
    L_uzT = _T(L_uz)
    X_tilde = _sym(L_zz_run - L_uzT @ Li_uz)
    r_tilde = L_z_run - _mv(L_uzT, Li_u)
    C = _sym(F_u @ lsolve(_T(F_u)))

    # Steps, then the terminal element (A = 0, C = 0: the terminal value
    # function itself).
    zmat = torch.zeros(lane + (1, nz, nz), dtype=dtype, device=device)
    zvec = torch.zeros(lane + (1, nz), dtype=dtype, device=device)
    steps = (F_tilde, c_tilde, C, -r_tilde, X_tilde)
    terminal = (zmat, zvec, zmat, -L_z[..., -1:, :], L_zz[..., -1:, :, :])
    if sharded:
        eta, J = _across_blocks(steps, terminal, group)
    else:
        _, _, _, eta, J = _suffix_scan(tuple(
            torch.cat([s, t], dim=a)
            for s, t, a in zip(steps, terminal, _TIME_DIMS)))
        eta, J = eta[..., 1:, :], J[..., 1:, :, :]
    S_next, s_next = J, -eta

    # The gains from the untransformed local model, over the horizon.
    F_uT = _T(F_u)
    Q_u = L_u + _mv(F_uT, s_next)
    Q_uz = L_uz + F_uT @ (S_next @ F_z)
    Q_uu = _sym(L_uu + F_uT @ (S_next @ F_u))
    kK = -(_psd_clamp_inv_with_reg(Q_uu, reg)
           @ torch.cat([Q_u[..., None], Q_uz], dim=-1))
    k, K = kK[..., 0], kK[..., 1:]
    ok = _all_finite(k, 2) & _all_finite(K, 3)
    if sharded:
        ok = any_rank((~ok).to(torch.int32), group) == 0
    return k, K, ok
