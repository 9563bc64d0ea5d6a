"""Pendulum dynamics (port of ``pddp_tpu/examples/pendulum/model.py``).

Damped pendulum with Euler integration; theta = 0 points up and increases
counter-clockwise. K2 (``csrc/fused_rollout.cu``) carries a copy of
``apply``'s arithmetic.
"""

from __future__ import annotations

import torch

from ...device import resolve_device
from ...encoding import StateEncoding, decode_mean, decode_var, encode
from ...models.base import DynamicsModel

__all__ = ["PendulumDynamicsModel"]

#: parameter names, in the order K2's parameter buffer holds them.
PARAM_NAMES = ("dt", "m", "l", "mu", "g")


class PendulumDynamicsModel(DynamicsModel):
    """Pendulum: state [theta, theta'], action [torque].

    Each physical parameter is a 0-d tensor on ``device`` (default
    ``cuda``) with ``dtype``.
    """

    state_size = 2
    action_size = 1
    angular_indices = (0,)
    non_angular_indices = (1,)

    def __init__(self, dt=0.1, m=1.0, l=1.0, mu=0.1, g=9.80665, *,
                 device=None, dtype=torch.float32):
        device = resolve_device(device)
        for name, v in zip(PARAM_NAMES, (dt, m, l, mu, g)):
            setattr(self, name, torch.as_tensor(v, dtype=dtype,
                                                device=device))

    def apply(self, z, u, i, aux,
              encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        mean = decode_mean(z, encoding)
        var = decode_var(z, encoding)

        theta = mean[..., 0]
        theta_dot = mean[..., 1]
        torque = u[..., 0]

        temp = self.m * self.l
        theta_dot_dot = (torque - self.mu * theta_dot
                         - 0.5 * temp * self.g * torch.sin(theta))
        theta_dot_dot = 3.0 * theta_dot_dot / (temp * self.l)

        mean_next = torch.stack([theta + theta_dot * self.dt,
                                 theta_dot + theta_dot_dot * self.dt], dim=-1)
        if encoding == StateEncoding.IGNORE_UNCERTAINTY:
            return mean_next
        return encode(mean_next, V=var, encoding=encoding)
