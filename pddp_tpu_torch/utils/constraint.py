"""Action constraints (port of ``pddp_tpu/utils/constraint.py``).

``constrain`` squashes actions through tanh; ``constrain_env`` and
``constrain_model`` are class decorators that apply it before an env's or
a model's ``apply``.

``boxqp`` is the projected-Newton box-QP that the constrained Riccati
backward solves at every step. It keeps ``pddp_tpu``'s semantics, quirks
included: the status stays 0 when the iteration budget runs out, the
Armijo backtracking runs as its own loop, the small-improvement break
returns the previous iteration's active set and factor, and a bound is
active only where x equals it exactly. Every argument may carry leading
batch dims (one QP per lane); the loops run until every lane is done,
with one host sync per iteration of each loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..encoding import StateEncoding
from .linalg import SMALL_N, small_cholesky, tria_solve

__all__ = ["BOXQP_RESULTS", "BoxQPResult", "boxqp", "chol_solve", "clamp",
           "constrain", "constrain_env", "constrain_model",
           "masked_cholesky"]

BOXQP_RESULTS = {
    -1: "Hessian is not positive definite",
    0: "No descent direction found",
    1: "Maximum main iterations exceeded",
    2: "Maximum line-search iterations exceeded",
    3: "No bounds, returning Newton point",
    4: "Improvement smaller than tolerance",
    5: "Gradient norm smaller than tolerance",
    6: "All dimensions are clamped",
}


def constrain(u, min_bounds, max_bounds):
    """Squashes an action into [min, max] through tanh."""
    diff = (max_bounds - min_bounds) / 2.0
    mean = (max_bounds + min_bounds) / 2.0
    return diff * torch.tanh(u) + mean


def _constrain_like(u, min_bounds, max_bounds):
    """``constrain`` with the bounds as tensors on ``u``'s device and in
    its dtype (an action that is not a tensor becomes one)."""
    u = torch.as_tensor(u)
    lo, hi = (torch.as_tensor(b, dtype=u.dtype, device=u.device)
              for b in (min_bounds, max_bounds))
    return constrain(u, lo, hi)


def constrain_env(min_bounds, max_bounds):
    """Class decorator constraining an env's actions: ``apply`` squashes
    ``u`` through tanh into [min, max] first. The decorated class is
    subclassed (named ``"Constrained" + cls.__name__``), not patched."""
    def decorator(cls):
        class Constrained(cls):
            def apply(self, u):
                return super().apply(_constrain_like(u, min_bounds,
                                                     max_bounds))

        Constrained.__name__ = "Constrained" + cls.__name__
        Constrained.__qualname__ = Constrained.__name__
        return Constrained

    return decorator


def constrain_model(min_bounds, max_bounds):
    """Class decorator constraining a dynamics model's actions: ``apply``
    squashes ``u`` through tanh into [min, max] before the dynamics, and
    the subclass (named ``"Constrained" + cls.__name__``) gains
    ``constrain(u)``. The subclass is marked with the class it subclassed
    (``_constrain_base``) and its bounds (``_constrain_bounds``), so that
    the line-search kernels, which carry the four examples' arithmetic,
    admit the constrained examples (``ops/_examples.example_of``); a
    further subclass is another type, whose line search runs the scan."""
    def decorator(cls):
        class Constrained(cls):
            def apply(self, z, u, i, aux,
                      encoding: StateEncoding = StateEncoding.DEFAULT,
                      **kwargs):
                return super().apply(z, self.constrain(u), i, aux, encoding,
                                     **kwargs)

            def constrain(self, u):
                return _constrain_like(u, min_bounds, max_bounds)

        Constrained._constrain_base = cls
        Constrained._constrain_bounds = (min_bounds, max_bounds)
        Constrained.__name__ = "Constrained" + cls.__name__
        Constrained.__qualname__ = Constrained.__name__
        return Constrained

    return decorator


def clamp(u, min_bounds, max_bounds):
    """Element-wise clamp."""
    return torch.minimum(torch.maximum(u, min_bounds), max_bounds)


def masked_cholesky(Q, free):
    """Upper Cholesky factor of Q restricted to the free subspace: the
    clamped rows and columns are replaced by the identity, so the factor
    keeps its shape and solves against it leave clamped entries alone.

    Returns:
        (U, ok): ok is False where the free block is not positive definite.
    """
    free_f = free.to(Q.dtype)
    outer = free_f[..., :, None] * free_f[..., None, :]
    n = Q.shape[-1]
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    Qm = Q * outer + eye * (1.0 - free_f[..., :, None])
    if n <= SMALL_N:
        U = small_cholesky(Qm)
    else:
        L, info = torch.linalg.cholesky_ex(Qm)
        U = torch.where((info == 0)[..., None, None], L,
                        torch.nan).transpose(-1, -2)
    ok = torch.isfinite(U).all(dim=-1).all(dim=-1)
    return U, ok


def chol_solve(U, b):
    """Solves (U^T U) x = b given the upper factor U."""
    return tria_solve(U, tria_solve(U, b, trans=True))


class BoxQPResult(NamedTuple):
    x: torch.Tensor          # solution
    result: torch.Tensor     # int32 status code (see BOXQP_RESULTS)
    U_free: torch.Tensor     # masked upper Cholesky factor of the free block
    free: torch.Tensor       # bool mask of free dimensions


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def boxqp(x0, Q, c, lower, upper, max_iter=100, min_grad=1e-8, tol=1e-8,
          step_dec=0.6, min_step=1e-22, armijo=0.1) -> BoxQPResult:
    """Projected-Newton box-QP: min 0.5 x'Qx + c'x s.t. lower <= x <= upper.

    x0, c, lower, upper (..., D) and Q (..., D, D) broadcast to one batch
    of QPs, all in their promoted dtype.
    """
    dtype = x0.dtype
    for t in (Q, c, lower, upper):
        dtype = torch.promote_types(dtype, t.dtype)
    device = Q.device
    D = Q.shape[-1]
    batch = torch.broadcast_shapes(x0.shape[:-1], Q.shape[:-2], c.shape[:-1],
                                   lower.shape[:-1], upper.shape[:-1])
    x0, c, lower, upper = (t.to(dtype).expand(batch + (D,))
                           for t in (x0, c, lower, upper))
    Q = Q.to(dtype).expand(batch + (D, D))

    def quad(xv):
        return 0.5 * (xv * _mv(Q, xv)).sum(-1) + (xv * c).sum(-1)

    x = clamp(x0, lower, upper)
    x = torch.where(torch.isinf(x), torch.zeros_like(x), x)
    f = quad(x)
    old_f = torch.zeros(batch, dtype=dtype, device=device)
    clamped_old = torch.zeros(batch + (D,), dtype=torch.bool, device=device)
    free_c = torch.ones(batch + (D,), dtype=torch.bool, device=device)
    U_c = torch.eye(D, dtype=dtype, device=device).expand(
        batch + (D, D)).clone()
    result = torch.zeros(batch, dtype=torch.int32, device=device)
    two = torch.tensor(2, dtype=torch.int32, device=device)

    for i in range(max_iter):
        running = result == 0
        if not bool(running.any()):
            break
        # Convergence on a small improvement, checked before anything else.
        conv = (((old_f - f) < tol * old_f.abs()) if i > 0
                else torch.zeros_like(running))

        g = _mv(Q, x) + c
        clamped = (((x == lower) & (g > 0)) | ((x == upper) & (g < 0)))
        free = ~clamped
        all_clamped = clamped.all(-1)

        factorize = ((clamped_old != clamped).any(-1) if i > 0
                     else torch.ones_like(running))
        U_new, chol_ok = masked_cholesky(Q, free)
        U = torch.where(factorize[..., None, None], U_new, U_c)
        chol_failed = factorize & ~chol_ok

        free_f = free.to(dtype)
        small_grad = torch.linalg.vector_norm(g * free_f, dim=-1) < min_grad
        g_clamped = _mv(Q, x * clamped.to(dtype)) + c
        search = (-chol_solve(U, g_clamped * free_f) - x) * free_f
        sdotg = (search * g).sum(-1)

        # Armijo backtracking, only on the lanes whose result it decides.
        early = conv | all_clamped | chol_failed | small_grad
        step = torch.ones(batch, dtype=dtype, device=device)
        xc = clamp(x + search, lower, upper)
        fc = quad(xc)
        ls_res = torch.zeros_like(result)
        while True:
            ls_active = (running & ~early & ((fc - f) / (step * sdotg) < armijo)
                         & (ls_res == 0))
            if not bool(ls_active.any()):
                break
            step = torch.where(ls_active, step * step_dec, step)
            xc = torch.where(ls_active[..., None],
                             clamp(x + step[..., None] * search, lower, upper),
                             xc)
            fc = torch.where(ls_active, quad(xc), fc)
            ls_res = torch.where(ls_active & (step < min_step), two, ls_res)

        res = torch.where(conv, 4, torch.where(
            all_clamped, 6, torch.where(chol_failed, -1, torch.where(
                small_grad, 5, ls_res)))).to(torch.int32)
        keep = running & ~early
        x_next = torch.where(keep[..., None], xc, x)
        f_next = torch.where(keep, fc, f)
        old_f_next = torch.where(conv, old_f, f)
        free_out = torch.where(conv[..., None], free_c, free)
        U_out = torch.where(conv[..., None, None], U_c, U)

        # Lanes that finished earlier keep their carry.
        r = running
        x = torch.where(r[..., None], x_next, x)
        f = torch.where(r, f_next, f)
        old_f = torch.where(r, old_f_next, old_f)
        clamped_old = torch.where(r[..., None], clamped, clamped_old)
        free_c = torch.where(r[..., None], free_out, free_c)
        U_c = torch.where(r[..., None, None], U_out, U_c)
        result = torch.where(r, res, result)
    return BoxQPResult(x=x, result=result, U_free=U_c, free=free_c)
