"""Cost and dynamics derivatives (port of ``pddp_tpu/utils/evaluation.py``).

The local quadratic model: cost Taylor coefficients ``l, l_z, l_u, l_zz,
l_uz, l_uu`` and dynamics Jacobians ``F_z, F_u``, all with respect to the
encoded state. Autodiff goes through ``torch.func``; callers batch over
the horizon with ``torch.func.vmap``.
"""

from __future__ import annotations

import torch
from torch.func import grad, hessian, jacfwd

from ..encoding import StateEncoding

__all__ = ["eval_cost", "eval_dynamics"]


def eval_cost(cost, z, u, i, terminal=False,
              encoding: StateEncoding = StateEncoding.DEFAULT,
              approximate=False, **kwargs):
    """Cost value and first/second derivatives at one (z, u).

    Costs with a closed form (``eval_derivatives`` not returning None)
    skip autodiff. ``approximate`` takes Gauss-Newton outer products in
    place of the exact Hessians.

    Returns:
        (l, l_z, l_u, l_zz, l_uz, l_uu); the u-entries are None when
        terminal.
    """
    deriv_fn = getattr(cost, "eval_derivatives", None)
    if deriv_fn is not None:
        out = deriv_fn(z, u, i, terminal=terminal, encoding=encoding,
                       approximate=approximate, **kwargs)
        if out is not None:
            return out

    if terminal:
        def fn(zz):
            return cost(zz, None, i, terminal=True, encoding=encoding,
                        **kwargs)

        l, l_z = fn(z), grad(fn)(z)
        l_zz = torch.outer(l_z, l_z) if approximate else hessian(fn)(z)
        return l, l_z, None, l_zz, None, None

    nz = z.shape[-1]
    zu = torch.cat([z, u], dim=-1)

    def fn(zu_):
        return cost(zu_[:nz], zu_[nz:], i, terminal=False, encoding=encoding,
                    **kwargs)

    l, g = fn(zu), grad(fn)(zu)
    l_z, l_u = g[:nz], g[nz:]
    if approximate:
        return (l, l_z, l_u, torch.outer(l_z, l_z), torch.outer(l_u, l_z),
                torch.outer(l_u, l_u))
    H = hessian(fn)(zu)
    return l, l_z, l_u, H[:nz, :nz], H[nz:, :nz], H[nz:, nz:]


def eval_dynamics(model, z, u, i, encoding: StateEncoding = StateEncoding.DEFAULT,
                  aux=None, **kwargs):
    """Next state and Jacobians F_z, F_u at one (z, u).

    ``aux`` is the per-step noise constant recorded by the rollout and
    replayed here (``model.aux_zero()`` when omitted), so the Jacobians
    are those of the step that was taken.
    """
    if aux is None:
        aux = model.aux_zero()
    jac_fn = getattr(model, "jacobians", None)
    if jac_fn is not None:
        res = jac_fn(z, u, i, aux, encoding=encoding, **kwargs)
        if res is not None:
            return res
    nz = z.shape[-1]

    def fn(zu_):
        out = model.apply(zu_[:nz], zu_[nz:], i, aux, encoding, **kwargs)
        return out, out

    J, z_next = jacfwd(fn, has_aux=True)(torch.cat([z, u], dim=-1))
    # Forward mode promotes the tangent of (0-d tensor) * (Python float)
    # to float64 whatever the primal's dtype; the Jacobian keeps the
    # state's dtype.
    J = J.to(z_next.dtype)
    return z_next, J[:, :nz], J[:, nz:]
