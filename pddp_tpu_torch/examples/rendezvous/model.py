"""Two-vehicle rendezvous dynamics (port of
``pddp_tpu/examples/rendezvous/model.py``).

Damped point masses with Euler integration. The full covariance is passed
through ``encode(C=...)`` unchanged, as in ``pddp_tpu``; under the
Cholesky codec that re-factorizes it through ``safe_cholesky``'s ladder
every step. K2 (``csrc/fused_rollout.cu``) carries a copy of ``apply``'s
arithmetic.
"""

from __future__ import annotations

import torch

from ...device import resolve_device
from ...encoding import StateEncoding, decode_covar, decode_mean, encode
from ...models.base import DynamicsModel

__all__ = ["RendezvousDynamicsModel"]

#: parameter names, in the order K2's parameter buffer holds them.
PARAM_NAMES = ("dt", "m", "alpha")


class RendezvousDynamicsModel(DynamicsModel):
    """Rendezvous: state [x0, y0, x1, y1, x0', y0', x1', y1'], action
    [Fx0, Fy0, Fx1, Fy1]."""

    state_size = 8
    action_size = 4
    angular_indices = ()
    non_angular_indices = (0, 1, 2, 3, 4, 5, 6, 7)

    def __init__(self, dt=0.1, m=1.0, alpha=0.1, *, device=None,
                 dtype=torch.float32):
        device = resolve_device(device)
        for name, v in zip(PARAM_NAMES, (dt, m, alpha)):
            setattr(self, name, torch.as_tensor(v, dtype=dtype,
                                                device=device))

    def _acceleration(self, x_dot, u):
        x_dot_dot = x_dot * (1.0 - self.alpha * self.dt / self.m)
        return x_dot_dot + u * self.dt / self.m

    def apply(self, z, u, i, aux,
              encoding: StateEncoding = StateEncoding.DEFAULT, **kwargs):
        dt = self.dt
        x = decode_mean(z, encoding)
        covar = decode_covar(z, encoding)
        mean_next = torch.stack(
            [x[..., j] + x[..., j + 4] * dt for j in range(4)]
            + [x[..., j + 4] + self._acceleration(x[..., j + 4],
                                                  u[..., j]) * dt
               for j in range(4)], dim=-1)
        return encode(mean_next, C=covar, encoding=encoding)
