"""Double cartpole dynamics (port of
``pddp_tpu/examples/double_cartpole/model.py``).

Each step assembles the 3x3 mass matrix A and b and solves A q'' = b
through the adjugate (``utils.linalg.small_solve``, the rounding of
``pddp_tpu``), then takes a symplectic Euler step. K2
(``csrc/fused_rollout.cu``) carries a copy of ``apply``'s arithmetic.
"""

from __future__ import annotations

import torch

from ...device import resolve_device
from ...encoding import StateEncoding, decode_mean, decode_var, encode
from ...models.base import DynamicsModel
from ...utils.linalg import small_solve

__all__ = ["DoubleCartpoleDynamicsModel"]

#: parameter names, in the order K2's parameter buffer holds them.
PARAM_NAMES = ("dt", "mc", "mp1", "mp2", "l1", "l2", "mu", "g")


class DoubleCartpoleDynamicsModel(DynamicsModel):
    """Double cartpole: state [x, x', th1, th1', th2, th2'], action [F]."""

    state_size = 6
    action_size = 1
    angular_indices = (2, 4)
    non_angular_indices = (0, 1, 3, 5)

    def __init__(self, dt=0.1, mc=0.5, mp1=0.5, mp2=0.5, l1=0.6, l2=0.6,
                 mu=0.1, g=9.80665, *, device=None, dtype=torch.float32):
        device = resolve_device(device)
        for name, v in zip(PARAM_NAMES, (dt, mc, mp1, mp2, l1, l2, mu, g)):
            setattr(self, name, torch.as_tensor(v, dtype=dtype,
                                                device=device))

    def apply(self, z, u, i, aux,
              encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        dt, mc, mp1, mp2, l1, l2, mu, g = (getattr(self, n)
                                           for n in PARAM_NAMES)
        mean = decode_mean(z, encoding)
        var = decode_var(z, encoding)

        x, x_dot, theta1, theta1_dot, theta2, theta2_dot = mean.unbind(-1)
        F = u[..., 0]

        sin_theta1 = torch.sin(theta1)
        cos_theta1 = torch.cos(theta1)
        sin_theta2 = torch.sin(theta2)
        cos_theta2 = torch.cos(theta2)
        sin_dtheta = torch.sin(theta1 - theta2)
        cos_dtheta = torch.cos(theta1 - theta2)

        a0 = mp2 + 2.0 * mc
        a1 = mc * l2
        a2 = l1 * theta1_dot**2
        a3 = a1 * theta2_dot**2
        ones = torch.ones_like(x)

        A = torch.stack([
            torch.stack([2.0 * (mp1 + mp2 + mc) * ones,
                         -a0 * l1 * cos_theta1,
                         -a1 * cos_theta2], dim=-1),
            torch.stack([-3.0 * a0 * cos_theta1,
                         (2.0 * a0 + 2.0 * mc) * l1 * ones,
                         3.0 * a1 * cos_dtheta], dim=-1),
            torch.stack([-3.0 * cos_theta2,
                         3.0 * l1 * cos_dtheta,
                         2.0 * l2 * ones], dim=-1),
        ], dim=-2)
        b = torch.stack([
            2.0 * F - 2.0 * mu * x_dot - a0 * a2 * sin_theta1
            - a3 * sin_theta2,
            3.0 * a0 * g * sin_theta1 - 3.0 * a3 * sin_dtheta,
            3.0 * a2 * sin_dtheta + 3.0 * g * sin_theta2,
        ], dim=-1)
        sol = small_solve(A, b)

        new_x_dot = x_dot + sol[..., 0] * dt
        new_theta1_dot = theta1_dot + sol[..., 1] * dt
        new_theta2_dot = theta2_dot + sol[..., 2] * dt
        mean_next = torch.stack([x + new_x_dot * dt, new_x_dot,
                                 theta1 + new_theta1_dot * dt, new_theta1_dot,
                                 theta2 + new_theta2_dot * dt,
                                 new_theta2_dot], dim=-1)
        return encode(mean_next, V=var, encoding=encoding)
