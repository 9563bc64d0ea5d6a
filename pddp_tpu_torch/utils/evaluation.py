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

__all__ = ["eval_cost", "eval_dynamics", "batch_eval_cost",
           "batch_eval_dynamics", "quadratize_cost", "linearize_dynamics"]


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


# ``pddp_tpu``'s names of the two, kept from the reference's batched
# variants (with ``torch.func`` the exact and batched paths coincide).
batch_eval_cost = eval_cost
batch_eval_dynamics = eval_dynamics


def _tree_map(fn, tree):
    """``fn`` over the tensors of a nest of tuples/lists/dicts (model aux)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flatten_lanes(t, lane):
    """(*lane, N, ...) -> (lanes * N, ...)."""
    return t.reshape((-1,) + t.shape[len(lane) + 1:])


def _lane_steps(U):
    """The step index of every entry of U (*lane, N, nu) flattened over
    lanes and steps."""
    N = U.shape[-2]
    idx = torch.arange(N, device=U.device)
    return idx.expand(U.shape[:-1]).reshape(-1)


def _unflatten_lanes(out, lane, N):
    return tuple(None if t is None else t.reshape(lane + (N,) + t.shape[1:])
                 for t in out)


def quadratize_cost(cost, Z_run, U, encoding: StateEncoding,
                    approximate=False, **kwargs):
    """Running-cost Taylor coefficients along a whole trajectory.

    A cost with a closed form (``eval_derivatives``) takes the whole
    trajectory in one call; any other is vmapped autodiff. Leading lane
    dims (a batch of solves) are flattened with the steps into one call,
    each entry with its own step index.

    Args:
        Z_run (Tensor<..., N, nz>): encoded states z_0..z_{N-1}.
        U (Tensor<..., N, nu>): actions.

    Returns:
        Tuple (L, L_z, L_u, L_zz, L_uz, L_uu) stacked over time.
    """
    lane = U.shape[:-2]
    N = U.shape[-2]
    idx = _lane_steps(U)
    Z_f, U_f = _flatten_lanes(Z_run, lane), _flatten_lanes(U, lane)
    deriv_fn = getattr(cost, "eval_derivatives", None)
    out = None
    if deriv_fn is not None and not approximate:
        out = deriv_fn(Z_f, U_f, idx, terminal=False, encoding=encoding,
                       approximate=approximate, **kwargs)
    if out is None:
        def one(z, u, i):
            return eval_cost(cost, z, u, i, terminal=False, encoding=encoding,
                             approximate=approximate, **kwargs)

        out = torch.func.vmap(one)(Z_f, U_f, idx)
    return _unflatten_lanes(out, lane, N)


def linearize_dynamics(model, Z_run, U, AUX, encoding: StateEncoding,
                       **kwargs):
    """Dynamics Jacobians along a whole trajectory, vmapped over time (and
    over leading lane dims, flattened with the steps, each entry with its
    own step index).

    Args:
        Z_run (Tensor<..., N, nz>): encoded states z_0..z_{N-1}.
        U (Tensor<..., N, nu>): actions.
        AUX: per-step aux nest stacked over time, each leaf (N, ..., *)
            with the lane dims after the time axis (from the rollout).

    Returns:
        Tuple (Z_next, F_z, F_u) stacked over time.
    """
    lane = U.shape[:-2]
    N = U.shape[-2]
    idx = _lane_steps(U)
    AUX = _tree_map(lambda a: _flatten_lanes(a.movedim(0, len(lane)), lane),
                    AUX)

    def one(z, u, i, aux):
        return eval_dynamics(model, z, u, i, encoding=encoding, aux=aux,
                             **kwargs)

    aux_dims = _tree_map(lambda _: 0, AUX)
    out = torch.func.vmap(one, in_dims=(0, 0, 0, aux_dims))(
        _flatten_lanes(Z_run, lane), _flatten_lanes(U, lane), idx, AUX)
    return _unflatten_lanes(out, lane, N)
