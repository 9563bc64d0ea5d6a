"""Quadratic expected cost (port of ``pddp_tpu/costs/quadratic.py``).

    E[L(x, u)] = tr(Q Sigma) + (mu - x*)^T Q (mu - x*) + (u - u*)^T R (u - u*)

``SaturatingQRCost`` is not on the known-dynamics path and is not ported
yet.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..encoding import StateEncoding, decode_covar, decode_mean
from .base import Cost

__all__ = ["QRCost", "augmented_qr_derivatives"]


def augmented_qr_derivatives(Q, R, x_goal, u_goal, x, u, terminal,
                             angular_indices=(), non_angular_indices=()):
    """Closed-form Taylor coefficients of an angular-augmented QR cost.

    For L = d^T Q d + du^T R du with d = aug(x) - x*, du = u - u*, and
    M = Q + Q^T, l_y = M d:

        l_x  = J^T l_y
        l_xx = J^T M J + diag(curv),
        curv[a_k] = -sin(th_k) l_y[s_k] - cos(th_k) l_y[c_k],

    where J is the (sparse, trigonometric) Jacobian of the augmentation.
    Mean-state only; x is the raw state, batched over leading dims.

    Returns:
        (l, l_z, l_u, l_zz, l_uz, l_uu); u-entries are None when terminal.
    """
    ai = tuple(int(a) for a in angular_indices)
    nai = tuple(int(a) for a in non_angular_indices)
    nx = x.shape[-1]
    batch = x.shape[:-1]
    dtype, device = x.dtype, x.device
    # Weights take the state's dtype (a solve lifts its states to the
    # widest dtype of its inputs and parameters).
    Q, R, x_goal, u_goal = (t.to(dtype) for t in (Q, R, x_goal, u_goal))
    M = Q + Q.T
    eye = torch.eye(nx, dtype=dtype, device=device)

    if ai:
        th = x[..., list(ai)]
        s, c = torch.sin(th), torch.cos(th)
        sc = torch.stack([s, c], dim=-1).flatten(-2)
        y = torch.cat([x[..., list(nai)], sc], dim=-1)
        rows = [eye[p].expand(batch + (nx,)) for p in nai]
        for k, a in enumerate(ai):
            rows.append(c[..., k, None] * eye[a])
            rows.append(-s[..., k, None] * eye[a])
        J = torch.stack(rows, dim=-2)                       # (..., ny, nx)
    else:
        y = x
        J = None

    d = y - x_goal
    l = (d * (d @ Q.T)).sum(-1)
    l_y = d @ M.T

    if J is None:
        l_z = l_y
        l_zz = M.expand(batch + M.shape)
    else:
        l_z = torch.einsum("...yi,...y->...i", J, l_y)
        MJ = torch.einsum("yw,...wi->...yi", M, J)
        l_zz = torch.einsum("...yi,...yj->...ij", J, MJ)
        nna = len(nai)
        curv = 0.0
        for k, a in enumerate(ai):
            w = (-s[..., k] * l_y[..., nna + 2 * k]
                 - c[..., k] * l_y[..., nna + 2 * k + 1])
            curv = curv + w[..., None] * eye[a]
        l_zz = l_zz + curv[..., :, None] * eye

    if terminal:
        return l, l_z, None, l_zz, None, None

    MR = R + R.T
    du = u - u_goal
    l = l + (du * (du @ R.T)).sum(-1)
    l_u = du @ MR.T
    l_uu = MR.expand(u.shape[:-1] + MR.shape)
    l_uz = torch.zeros(u.shape[:-1] + (u.shape[-1], nx), dtype=dtype,
                       device=device)
    return l, l_z, l_u, l_zz, l_uz, l_uu


def _quad_form(d, M):
    """d^T M d batched over leading dims."""
    return ((d @ M) * d).sum(-1)


class QRCost(Cost):
    """Quadratic cost on the state distribution.

    Args:
        Q, R: state and action weights (array-likes).
        Q_term: terminal state weight (defaults to Q).
        x_goal, u_goal: goals (array-likes or scalars).
        device: defaults to ``cuda`` (see ``resolve_device``).
        dtype: dtype of every parameter tensor.
    """

    #: static augmentation applied by ``__call__`` in subclasses that wrap
    #: the state through ``augment_state``; plain QRCost applies none.
    aug_angular_indices = ()
    aug_non_angular_indices = ()
    #: subclasses whose ``__call__`` is exactly augment -> QRCost set this
    #: True to enable the closed-form local model.
    call_is_augmented_qr = False

    def __init__(self, Q, R, Q_term=None, x_goal=0.0, u_goal=0.0, *,
                 device=None, dtype=torch.float32):
        device = resolve_device(device)

        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        self.Q = t(Q)
        self.R = t(R)
        self.Q_term = self.Q if Q_term is None else t(Q_term)
        self.x_goal = t(x_goal)
        self.u_goal = t(u_goal)

    def __call__(self, z, u, i, terminal=False,
                 encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        Q = (self.Q_term if terminal else self.Q).to(z.dtype)
        cost = _quad_form(decode_mean(z, encoding) - self.x_goal, Q)
        if not terminal:
            cost = cost + _quad_form(u - self.u_goal, self.R.to(u.dtype))
        if encoding != StateEncoding.IGNORE_UNCERTAINTY:
            C = decode_covar(z, encoding)
            cost = cost + (C * Q.T).sum(dim=(-2, -1))
        return cost

    def eval_derivatives(self, z, u, i, terminal=False,
                         encoding: StateEncoding = StateEncoding.DEFAULT,
                         approximate=False, **kwargs):
        """Closed-form Taylor coefficients, or None (meaning: use
        autodiff) for belief encodings, Gauss-Newton mode, or subclasses
        whose ``__call__`` is more than augment -> QRCost."""
        if (encoding != StateEncoding.IGNORE_UNCERTAINTY or approximate
                or kwargs):
            return None
        if (type(self).__call__ is not QRCost.__call__
                and not type(self).call_is_augmented_qr):
            return None
        Q = self.Q_term if terminal else self.Q
        return augmented_qr_derivatives(
            Q, self.R, self.x_goal, self.u_goal, z, u, terminal,
            angular_indices=self.aug_angular_indices,
            non_angular_indices=self.aug_non_angular_indices)
