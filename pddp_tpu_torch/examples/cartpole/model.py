"""Cartpole dynamics (port of ``pddp_tpu/examples/cartpole/model.py``).

Damped cartpole with symplectic Euler integration; theta = 0 points up
and increases clockwise. K2 (``csrc/fused_rollout.cu``) carries a copy of
``apply``'s arithmetic for IGNORE_UNCERTAINTY.
"""

from __future__ import annotations

import torch

from ...device import resolve_device
from ...encoding import StateEncoding, decode_mean, decode_var, encode
from ...models.base import DynamicsModel

__all__ = ["CartpoleDynamicsModel"]

#: parameter names, in the order K2's parameter buffer holds them.
PARAM_NAMES = ("dt", "mc", "mp", "l", "mu", "g")


class CartpoleDynamicsModel(DynamicsModel):
    """Cartpole: state [x, x', theta, theta'], action [F].

    Each physical parameter is a 0-d tensor on ``device`` (default
    ``cuda``) with ``dtype``.
    """

    state_size = 4
    action_size = 1
    angular_indices = (2,)
    non_angular_indices = (0, 1, 3)

    def __init__(self, dt=0.1, mc=0.5, mp=0.5, l=0.5, mu=0.1, g=9.82, *,
                 device=None, dtype=torch.float32):
        device = resolve_device(device)
        for name, v in zip(PARAM_NAMES, (dt, mc, mp, l, mu, g)):
            setattr(self, name, torch.as_tensor(v, dtype=dtype,
                                                device=device))

    def apply(self, z, u, i, aux,
              encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        dt, mc, mp, l, mu, g = (getattr(self, n) for n in PARAM_NAMES)
        mean = decode_mean(z, encoding)
        var = decode_var(z, encoding)

        x, x_dot, theta, theta_dot = mean.unbind(-1)
        F = u[..., 0]
        sin_theta = torch.sin(theta)
        cos_theta = torch.cos(theta)

        a0 = mp * l * theta_dot**2 * sin_theta
        a1 = g * sin_theta
        a2 = F - mu * x_dot
        a3 = 4.0 * (mc + mp) - 3.0 * mp * cos_theta**2

        theta_dot_dot = -3.0 * (a0 * cos_theta + 2.0 * (
            (mc + mp) * a1 + a2 * cos_theta)) / (l * a3)
        x_dot_dot = (2.0 * a0 + 3.0 * mp * a1 * cos_theta + 4.0 * a2) / a3

        new_x_dot = x_dot + x_dot_dot * dt
        new_theta_dot = theta_dot + theta_dot_dot * dt
        mean_next = torch.stack([x + new_x_dot * dt, new_x_dot,
                                 theta + new_theta_dot * dt, new_theta_dot],
                                dim=-1)
        return encode(mean_next, V=var, encoding=encoding)
